"""The OOM contract of ``repro/train/autotune.py``: which exceptions mean
that a step ran out of device memory. The supervisor's shrink ladder and
the chaos plans' injected faults rest on it.

The autotune search itself (``autotune``, ``TuneSpace``, ``TunePlan``,
the probe runners; the launcher's ``--autotune`` / ``--tune-plan``) is
not ported yet.
"""
from __future__ import annotations

# substrings that mark an exception as device memory exhaustion: the
# reference's tokens. The first is jaxlib's status and the injection
# contract; "out of memory" matches PyTorch's
# ``torch.cuda.OutOfMemoryError("CUDA out of memory. ...")`` too
OOM_TOKENS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
              "OOM")


def is_oom(exc: BaseException) -> bool:
    """Does this exception mean the step ran out of device memory? Matched
    on the type name and message, so a scripted ``InjectedOOM`` (a plain
    RuntimeError) and the allocator's own error both match. Everything
    else is a real fault and must propagate."""
    text = f"{type(exc).__name__}: {exc}"
    return any(tok in text for tok in OOM_TOKENS)

"""The counter that launch analysis records into while it traces a step.

A ``Census`` collects what one call of a step issues: the kernels the
wrappers would launch (``kernel``), the collectives the mesh wrappers
would run (``collective``), and, under ``launch.roofline.analyze_step``'s
dispatch mode, the matmul flops and the bytes of every other op. While
``counting(census)`` is open it is the active census: the kernel wrappers
record into it on the ``meta`` device (where nothing launches), and the
collectives of ``launch/mesh.py`` record into it on every device, real
process groups and virtual ones alike. Outside ``counting`` nothing is
recorded and nothing costs more.

The conventions are those of the reference's ``analyze_hlo``
(``repro/launch/roofline.py``): collectives under its ``COLLECTIVES`` names
with their result bytes, classified by axis as its ``_classify_axis``
does (``model`` when the group's ranks lie in one model row, ``data``
when they are congruent modulo the model size, else ``mixed``); a kernel
counts as a ``custom-call`` does there, its operands' and results' bytes
into ``bytes`` and no flops; its own ``cost()`` (the reckoning of its
bound) goes under ``kernels``.
"""
from __future__ import annotations

import contextlib

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
AXES = ("model", "data", "mixed", "unknown")

_ACTIVE = []        # the open censuses, innermost last


def tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


def classify_axis(ids, n_model: int) -> str:
    """Which mesh axis a collective over global ranks ``ids`` spans, by
    the reference's rule (ranks row-major over ``(..., data, model)``)."""
    ids = list(ids)
    if len(ids) < 2:
        return "unknown"
    if all(i // n_model == ids[0] // n_model for i in ids):
        return "model"
    if all(i % n_model == ids[0] % n_model for i in ids):
        return "data"
    return "mixed"


class Census:
    """What one traced call issued. ``n_model`` is the size of the mesh's
    ``model`` axis (1 without one), for ``classify_axis``."""

    def __init__(self, n_model: int = 1):
        self.n_model = int(n_model)
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = {k: {"bytes": 0.0, "count": 0.0}
                            for k in COLLECTIVES}
        self.axis_bytes = {a: 0.0 for a in AXES}
        self.kernels = {}
        self.live = 0            # bytes of the tensors the trace made
        self.peak = 0

    def kernel(self, name, cost, operands=(), results=()):
        """One call of kernel ``name`` whose ``cost()`` is ``cost``. A
        launch passes its operands and results, whose bytes count into
        ``bytes``; a wrapper over several launches passes none (its
        launches count their own)."""
        row = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                             "bytes": 0.0})
        row["calls"] += 1
        row["flops"] += float(cost["flops"])
        row["bytes"] += float(cost["bytes"])
        self.bytes += float(sum(tensor_bytes(t) for t in operands
                                if t is not None)
                            + sum(tensor_bytes(t) for t in results
                                  if t is not None))

    def collective(self, kind, nbytes, ranks, count=1):
        """``count`` collectives of ``kind`` whose results hold ``nbytes``
        in all, over the global ``ranks``."""
        if kind not in self.collectives:
            raise ValueError(f"unknown collective {kind!r}")
        self.collectives[kind]["bytes"] += float(nbytes)
        self.collectives[kind]["count"] += float(count)
        self.axis_bytes[classify_axis(ranks, self.n_model)] += float(nbytes)

    def result(self):
        """The reference's ``analyze_hlo`` keys, plus ``kernels`` and the
        trace's peak of live bytes (``peak_live_bytes``)."""
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": {k: dict(v)
                                for k, v in self.collectives.items()},
                "collective_axis_bytes": dict(self.axis_bytes),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "peak_live_bytes": self.peak}


def active():
    """The innermost open census, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def counting(census: Census):
    """Make ``census`` the active one inside the block."""
    _ACTIVE.append(census)
    try:
        yield census
    finally:
        _ACTIVE.pop()


def record_kernel(name, cost, operands=(), results=()):
    """``Census.kernel`` on the active census, if one is open."""
    c = active()
    if c is not None:
        c.kernel(name, cost, operands, results)

"""Roofline arithmetic on the H100: the round, overlap, probe, serving and
supervisor models (counterpart of the arithmetic half of
``repro/launch/roofline.py``; its formulas unchanged, its constants the
card's).

Hardware model, NVIDIA H100 80GB HBM3 (SXM), 700 W power limit:

* ``PEAK_FLOPS`` — 989 TFLOP/s, dense bf16 on the tensor cores (NVIDIA's
  H100 SXM data sheet); the figure ``chip_smoke.py``'s kernel bounds use.
* ``HBM_BW`` — 3.35 TB/s (the same data sheet).
* ``LINK_BW`` — 450 GB/s each way a card, NVLink 4 (the same data sheet:
  900 GB/s both ways). Not measured: ranks that share one card meet
  over gloo, which stages every byte through host memory at ~1.1 GB/s
  (measured on one H100 80GB HBM3 at 700 W, ``chip_smoke.py`` phase 15).
* ``DISK_BW`` — ~1.04 GB/s, measured: a 33.47 GB resume point read back
  onto one H100 80GB HBM3 (700 W) in 23.8-32.2 s over five runs, warm
  page cache (``chip_smoke.py`` phase 16(b),
  ``checkpoint.load_train_state``); the slowest of those reads.

The other half of the reference's module counts a compiled step's work
from its HLO (``analyze_hlo``). Here ``analyze_step`` counts one call of a
step from a trace: the step runs on ``meta`` tensors (nothing is
allocated or launched) under a ``TorchDispatchMode`` that sees every op
PyTorch dispatches, its backward and rematerialized forwards included;
the kernel wrappers and the mesh's collectives record into the active
``launch.census.Census``. Its keys are ``analyze_hlo``'s, under its
conventions:

* ``flops``: matmul-class ops only (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``_scaled_mm``, fused attention), 2 M N K, by
  ``torch.utils.flop_counter``'s formulas: the reference's ``dot`` rule.
  Elementwise work and the kernels' own operations are not counted
  there (a kernel's are under ``kernels``).
* ``bytes``: each op's operands plus its results. Views, reshapes and
  allocations are skipped, as ``_SKIP_BYTES_OPS`` skips parameters,
  bitcasts and tuples; a kernel counts as a ``custom-call``, its operands'
  and results' bytes. These are bytes before any fusion (PyTorch runs op
  by op), so they read above XLA's fused count; they are not held against
  the reference's.
* ``collectives`` / ``collective_axis_bytes``: the mesh's collectives
  with their result bytes by kind and by axis (``model``, ``data``,
  ``mixed``, ``unknown``), as ``launch/mesh.py`` records them from a
  ``VirtualMesh`` or a real one.
* ``kernels`` (new): ``{name: {"calls", "flops", "bytes"}}``, each
  kernel wrapper's calls at its package's ``cost()``.

A step with a loop (the tau local steps) is traced as it runs, so no
trip-count correction is needed. ``peak_live_bytes`` is the largest sum
of the tensors the trace made that were alive at once: the dispatch
trace's peak, not an allocator's.
"""
from __future__ import annotations

import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.census import COLLECTIVES, Census, counting
from repro_torch.train.clock import OVERLAP_MODES

PEAK_FLOPS = 989e12     # bf16 dense, H100 SXM data sheet
HBM_BW = 3.35e12        # H100 SXM data sheet
LINK_BW = 450e9         # NVLink 4, each way, H100 SXM data sheet
DISK_BW = 33.47e9 / 32.2  # resume-point read, measured (warm), slowest


def roofline(flops, bytes_accessed, coll, *, seconds_scale=1.0):
    """Three roofline terms in seconds (optionally scaled, e.g. 1/tau to
    amortize a fused round over its local steps)."""
    total_coll = sum(v["bytes"] for v in coll.values())
    terms = {
        "compute_s": flops / PEAK_FLOPS * seconds_scale,
        "memory_s": bytes_accessed / HBM_BW * seconds_scale,
        "collective_s": total_coll / LINK_BW * seconds_scale,
    }
    terms["bottleneck"] = max(
        [k for k in terms if k.endswith("_s")], key=lambda k: terms[k])
    return terms


def overlap_model(terms, axis_bytes, *, R=8, seconds_scale=1.0):
    """Modeled round time of each overlap mode against the comm/compute
    crossover. ``work = compute_s + memory_s`` is the window the
    consensus traffic may hide behind; the worker-axis ("data") payload is
    the worker-row gather plus the (R, R) partial-Gram all-reduce, and
    tensor-parallel ("model") traffic is serial in every mode:

    * exact (``none``): ``work + model_s + data_s``
    * ``staleness1``: the stale all-reduce hides, the fresh gather does not:
      ``work + model_s + max(data_s - psum_s, 0) + max(psum_s - work, 0)``
    * ``doublebuf``: ``work + model_s + max(data_s - work, 0)``
    * ``staleness_k``: a ring of R - 1 hops, k rounds of compute to hide
      it: ``work + model_s + max(ring_s - k * work, 0)`` with
      ``ring_s = data_s * (R - 1) / R``.

    ``crossover = data_s / work``. By construction ``staleness_k_s[k] <=
    doublebuf_s <= staleness1_s <= exact_s``."""
    work = terms["compute_s"] + terms["memory_s"]
    model_s = axis_bytes.get("model", 0.0) / LINK_BW * seconds_scale
    gather_bytes = (axis_bytes.get("data", 0.0)
                    + axis_bytes.get("mixed", 0.0)
                    + axis_bytes.get("unknown", 0.0))
    data_s = gather_bytes / LINK_BW * seconds_scale
    psum_s = min(R * R * 4 / LINK_BW * seconds_scale, data_s)
    ring_s = data_s * (R - 1) / max(R, 1)
    rows = {
        "exact_s": work + model_s + data_s,
        "staleness1_s": (work + model_s + max(data_s - psum_s, 0.0)
                         + max(psum_s - work, 0.0)),
        "doublebuf_s": work + model_s + max(data_s - work, 0.0),
        "gather_bytes": gather_bytes,
        "ring_bytes_per_hop": gather_bytes / max(R, 1),
        "ring_hops": R - 1,
        "ring_s": ring_s,
        "staleness_k_s": {str(k): work + model_s + max(ring_s - k * work,
                                                       0.0)
                          for k in (1, 2, 4)},
    }
    rows["crossover"] = data_s / work if work > 0 else float("inf")
    rows["overlap_gain"] = (rows["exact_s"] / rows["doublebuf_s"]
                            if rows["doublebuf_s"] > 0 else 1.0)
    return rows


def probe_round_model(*, work_s_per_step: float, tau: int,
                      gather_bytes: float, R: int = 8, mode: str = "none",
                      staleness: int = 1) -> float:
    """One overlap mode's modeled round seconds for an autotune probe:
    tau local steps of ``work_s_per_step`` against a ``gather_bytes``
    worker-axis payload, through ``overlap_model``. ValueError on an
    unknown mode, tau < 1 or staleness < 1."""
    if mode not in OVERLAP_MODES:
        raise ValueError(f"unknown overlap mode {mode!r}")
    if tau < 1:
        raise ValueError(f"tau must be >= 1, got {tau}")
    if staleness < 1:
        raise ValueError(f"staleness must be >= 1, got {staleness}")
    rows = overlap_model(
        {"compute_s": work_s_per_step * tau, "memory_s": 0.0},
        {"data": float(gather_bytes)}, R=R)
    if mode == "none":
        return rows["exact_s"]
    if mode == "staleness1":
        return rows["staleness1_s"]
    if mode == "doublebuf":
        return rows["doublebuf_s"]
    by_k = rows["staleness_k_s"].get(str(staleness))
    if by_k is not None:
        return by_k
    work = work_s_per_step * tau
    return work + max(rows["ring_s"] - staleness * work, 0.0)


def reconcile_probes(pairs):
    """Model against measurement: ``pairs`` yields (measured_us,
    modeled_us). The median measured / modeled ratio is the calibration
    ``scale`` (one positive scale never moves an argmin of per-sample
    scores); ``max_abs_log_residual`` is the worst probe's distance from
    the scaled model. No usable pair: the identity scale."""
    ratios = sorted(m / md for m, md in pairs if md > 0 and m > 0)
    if not ratios:
        return {"scale": 1.0, "max_abs_log_residual": 0.0, "n": 0}
    n = len(ratios)
    if n % 2:
        scale = ratios[n // 2]
    else:
        scale = 0.5 * (ratios[n // 2 - 1] + ratios[n // 2])
    worst = max(abs(math.log(r / scale)) for r in ratios)
    return {"scale": scale, "max_abs_log_residual": worst, "n": n}


def model_flops(cfg, shape, *, mode: str) -> float:
    """6 N D for training (N the active parameters), 2 N D for prefill and
    decode; decode's D is one token a sequence. All devices together."""
    n = cfg.active_param_count()
    if mode in ("train", "ddp"):
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch        # decode: one token a sequence
    return 2.0 * n * tokens


def serving_model(cfg, *, max_slots: int, chunk: int,
                  state_bytes_per_slot: float, dtype_bytes: int = 2):
    """Prefill against decode for the continuous-batching engine. Decode
    reads every parameter and each slot's state (read and written) for
    one token a slot; a prefill chunk is C tokens against one slot's
    state. ``crossover_slots`` is where a decode step stops being a
    parameter stream; ``prefill_tokens_per_decode_step`` how many chunked
    prefill tokens cost one decode step."""
    if max_slots < 1:
        raise ValueError(f"max_slots must be >= 1, got {max_slots}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    n_act = cfg.active_param_count()
    param_bytes = cfg.param_count() * dtype_bytes

    dec_compute = 2.0 * n_act * max_slots / PEAK_FLOPS
    dec_memory = (param_bytes
                  + 2.0 * max_slots * state_bytes_per_slot) / HBM_BW
    decode_s = max(dec_compute, dec_memory)

    pre_compute = 2.0 * n_act * chunk / PEAK_FLOPS
    pre_memory = (param_bytes + 2.0 * state_bytes_per_slot) / HBM_BW
    prefill_s = max(pre_compute, pre_memory)

    denom = 2.0 * n_act / PEAK_FLOPS - 2.0 * state_bytes_per_slot / HBM_BW
    crossover = (param_bytes / HBM_BW) / denom if denom > 0 else float("inf")

    return {
        "params_bytes": float(param_bytes),
        "state_bytes_per_slot": float(state_bytes_per_slot),
        "decode_s": decode_s,
        "decode_bound": "compute" if dec_compute >= dec_memory else "memory",
        "decode_tok_s": max_slots / decode_s,
        "prefill_s": prefill_s,
        "prefill_bound": "compute" if pre_compute >= pre_memory else "memory",
        "prefill_tok_s": chunk / prefill_s,
        "crossover_slots": crossover,
        "prefill_tokens_per_decode_step": decode_s / (prefill_s / chunk),
    }


def supervisor_model(*, rounds: int, tau: int, work_s_per_step: float,
                     gather_bytes: float, R: int = 8, staleness: int = 1,
                     degraded_rounds: int = 0, retried_rounds: int = 0,
                     restores: int = 0, restore_bytes: float = 0.0,
                     backoff_s: float = 0.0):
    """The supervisor's fault timeline priced with ``probe_round_model``
    (``staleness_k``): a degraded round costs only its local window, a
    retried round one more round plus, for each restore, the checkpoint
    read at ``DISK_BW``; backoff adds wall time. Returns fault-free and
    faulted seconds and the overhead fraction, each rounded to 6
    digits."""
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    if not 0 <= degraded_rounds <= rounds:
        raise ValueError(
            f"degraded_rounds must be in [0, rounds], got "
            f"{degraded_rounds} of {rounds}")
    if retried_rounds < 0 or restores < 0:
        raise ValueError(
            f"retried_rounds ({retried_rounds}) and restores ({restores}) "
            "must be >= 0")
    if restore_bytes < 0 or backoff_s < 0:
        raise ValueError(
            f"restore_bytes ({restore_bytes}) and backoff_s ({backoff_s}) "
            "must be >= 0")
    round_s = probe_round_model(
        work_s_per_step=work_s_per_step, tau=tau,
        gather_bytes=gather_bytes, R=R, mode="staleness_k",
        staleness=staleness)
    local_s = work_s_per_step * tau
    fault_free_s = rounds * round_s
    degraded_saved_s = degraded_rounds * (round_s - local_s)
    restore_s = restores * (float(restore_bytes) / DISK_BW)
    retry_s = retried_rounds * round_s
    faulted_s = (fault_free_s - degraded_saved_s + retry_s + restore_s
                 + float(backoff_s))
    out = {
        "round_s": round_s,
        "local_s": local_s,
        "fault_free_s": fault_free_s,
        "degraded_saved_s": degraded_saved_s,
        "retry_s": retry_s,
        "restore_s": restore_s,
        "backoff_s": float(backoff_s),
        "faulted_s": faulted_s,
        "overhead_frac": (faulted_s / fault_free_s - 1.0
                          if fault_free_s > 0 else 0.0),
    }
    return {k: round(v, 6) for k, v in out.items()}


# ---------------------------------------------------------------------------
# counting a traced step (the counterpart of the reference's analyze_hlo)
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
_MATMUL = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm, _aten._scaled_mm,
           _aten._scaled_dot_product_flash_attention,
           _aten._scaled_dot_product_flash_attention_backward,
           _aten._scaled_dot_product_efficient_attention,
           _aten._scaled_dot_product_efficient_attention_backward,
           _aten._flash_attention_forward, _aten._flash_attention_backward,
           _aten._efficient_attention_forward,
           _aten._efficient_attention_backward}
# no data moves: allocations, aliasing and shape queries
_SKIP_BYTES = {_aten.empty, _aten.empty_strided, _aten.empty_like,
               _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
               _aten.resize_, _aten.set_, _aten.lift_fresh, _aten.sym_size,
               _aten.sym_stride, _aten.sym_numel, _aten.sym_storage_offset,
               _aten.is_same_size}


_KEYABLE = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.memory_format, torch.layout)
_FUNCTIONAL = {}
# op and input metadata -> output metadata, shared by every trace (pure
# functions of their keys); cleared when it grows past _MEMO_MAX
_MEMO = {}
_MEMO_MAX = 1 << 17


def _leaves(x, out):
    """The leaves of nested tuples, lists and dicts (an op's arguments)."""
    if isinstance(x, (tuple, list)):
        for y in x:
            _leaves(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _leaves(y, out)
    else:
        out.append(x)
    return out


def _functional(func):
    """Whether ``func`` writes none of its arguments and returns no alias
    of one: its outputs' metadata is a function of its inputs'."""
    got = _FUNCTIONAL.get(func)
    if got is None:
        schema = func._schema
        got = _FUNCTIONAL[func] = not func.is_view and not any(
            a.alias_info is not None
            for a in list(schema.arguments) + list(schema.returns))
    return got


def _meta_of(t):
    return tuple(t.shape), t.stride(), t.dtype


def _empty(meta):
    shape, stride, dtype = meta
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


class _Counting(TorchDispatchMode):
    """Adds every dispatched op's matmul flops and bytes to a census, and
    tracks the bytes of the tensors the ops make while they live.

    On ``meta`` a functional op's outputs depend only on its inputs'
    shapes, strides and dtypes and its other arguments, so they are made
    from a memo of the first call's (``empty_strided``) instead of running
    the op's meta function again: a traced step repeats the same few
    hundred ops in every layer and local step, and the meta functions of
    elementwise ops run in Python."""

    def __init__(self, census: Census):
        super().__init__()
        self.census = census
        if len(_MEMO) > _MEMO_MAX:
            _MEMO.clear()
        self.memo = _MEMO

    def _free(self, nbytes):
        self.census.live -= nbytes

    def _key(self, func, leaves):
        key = [func]
        for x in leaves:
            if isinstance(x, torch.Tensor):
                if x.device.type != "meta":
                    return None
                key.append(_meta_of(x))
            elif isinstance(x, _KEYABLE):
                key.append((type(x), x))
            else:
                return None
        return tuple(key)

    def _run(self, func, args, kwargs, leaves):
        key = self._key(func, leaves) if _functional(func) else None
        hit = self.memo.get(key) if key is not None else None
        if hit is not None:
            kind, metas = hit
            if kind is None:
                return _empty(metas)
            return kind(_empty(m) for m in metas)
        out = func(*args, **kwargs)
        if key is not None:
            if isinstance(out, torch.Tensor):
                self.memo[key] = (None, _meta_of(out))
            elif isinstance(out, (tuple, list)) and all(
                    isinstance(t, torch.Tensor) for t in out):
                self.memo[key] = (type(out), [_meta_of(t) for t in out])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = _leaves(kwargs, _leaves(args, []))
        out = self._run(func, args, kwargs, leaves)
        packet = func.overloadpacket
        c = self.census
        if packet in _MATMUL:
            from torch.utils.flop_counter import flop_registry
            c.flops += float(flop_registry[packet](*args, **kwargs,
                                                   out_val=out))
        if func.is_view or packet in _SKIP_BYTES:
            return out
        ins = [t for t in leaves if isinstance(t, torch.Tensor)]
        outs = [t for t in _leaves(out, []) if isinstance(t, torch.Tensor)]
        nbytes = 0
        for t in ins:
            nbytes += t.numel() * t.element_size()
        for t in outs:
            size = t.numel() * t.element_size()
            nbytes += size
            if any(t is a for a in ins):        # in place: nothing new
                continue
            c.live += size
            if c.live > c.peak:
                c.peak = c.live
            weakref.finalize(t, self._free, size)
        c.bytes += float(nbytes)
        return out


def _n_model(mesh):
    return mesh.shape.get("model", 1) if mesh is not None else 1


def analyze_step(fn, *args, mesh=None):
    """Count one call ``fn(*args)``: ``{"flops", "bytes", "collectives",
    "collective_axis_bytes", "kernels", "peak_live_bytes"}`` (the module
    docstring says what each counts). Pass ``meta`` tensors (and a
    ``launch.mesh.VirtualMesh`` for a sharded step) to count without
    computing; on real tensors the step runs as well. ``mesh`` sizes the
    ``model`` axis that classifies the collectives."""
    census = Census(_n_model(mesh))
    with counting(census), _Counting(census):
        fn(*args)
    return census.result()


def collective_bytes(fn, *args, mesh):
    """The collectives of one call ``fn(*args)`` on ``mesh`` (real or
    virtual), ``{kind: {"bytes", "count"}}`` over ``COLLECTIVES``, as
    ``analyze_step`` counts them, without tracing the ops."""
    census = Census(_n_model(mesh))
    with counting(census):
        fn(*args)
    return {k: dict(census.collectives[k]) for k in COLLECTIVES}

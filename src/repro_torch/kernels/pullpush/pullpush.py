"""Hopper kernels for the DPPF consensus stage, and their wrappers.

Replaces ``src/repro/kernels/pullpush/pullpush.py``:

* ``fused_round`` ← ``fused_round`` (``_fused_round_kernel``): one
  consensus stage. The TPU's single two-phase ``pallas_call`` becomes two
  launches on the current stream — ``partial_gram``, whose last block to
  finish runs the coefficient phase (``_coef``), then ``mix_shard`` —
  because Hopper blocks cannot wait on each other the way TPU grid steps
  run in order (``csrc/pullpush.cu`` says how).
* ``partial_gram`` ← ``partial_gram`` (``_partial_gram_kernel``):
  block-centered Gram of a column shard, or of a column chunk
  ``x[:, a:b]`` read in place (its rows lie ``x.stride(0)`` floats apart),
  summed in the same launch. Bound: memory, R·n·4 bytes read.
* ``mix_shard`` ← ``mix_shard`` (``_mix_kernel``): the uniform gap-form
  mix with given coefficients. Bound: memory, 2·R·n·4 bytes (read +
  write).
* ``mix_from_gram`` ← ``mix_from_gram``: a stage whose Gram is given (the
  summed ``partial_gram`` chunks of the overlap modes): one ``mix_shard``
  launch — or, with ``base``, one ``stale_mix`` launch — whose blocks
  compute the coefficients from the Gram in their prologue.
* ``fused_round_sharded`` ← ``fused_round_sharded`` (a composite over
  ``partial_gram`` and ``mix_shard`` with a ``lax.psum`` between them):
  the stage on one rank's (R, n_local) column shard — ``pp_partial_gram``
  with its summing tail, the (R, R) Gram's all-reduce over the column
  group (``launch.mesh.all_reduce``), then one ``mix_shard`` (or
  ``stale_mix``) launch with the coefficient prologue. Bound: memory,
  3·R·n_local·4 bytes (x read for the Gram, read and written by the mix).
* ``gram_coef`` ← the ``_coef`` phase of ``_fused_round_kernel``, alone:
  one block sums a stack of partial Grams in a fixed order and computes r
  and coef. No stage launches it: the partial-Gram tail and the mix
  prologue run its code, and it stays as their standalone counterpart.
* ``stale_mix``: the overlap modes' stale epilogue ``q + (mix(s) − s)``
  (``src/repro/train/trainer.py:387, :449``, three (R, n) passes there)
  as one pass. Bound: memory, 3·R·n·4 bytes (s and q read, out written).
* ``fused_round_leaves`` ← ``src/repro/kernels/pullpush/ops.py``'s
  ``pullpush_fused`` (flatten, ``fused_round``, unflatten): the same two
  passes on a worker-stacked tree's own leaves, read in place as float32
  or bfloat16 through a device table of the leaves (``leaf_table``), each
  result rounded to its leaf's dtype into a new tree — no (M, n) fp32
  view. Bound: memory, the tree read twice and written once.
* ``sq_dist`` ← ``sq_dist`` (``_sq_dist_kernel``): ``Σ (x − a)²`` of two
  (n,) vectors, fp32 accumulation, in a fixed order (two launches: block
  partials into a scratch buffer, then one block adds them). Bound:
  memory, n·(sizeof x + sizeof a) bytes read.
* ``apply_update`` ← ``apply_update`` (``_apply_kernel``): ``x + (a −
  x)·coef`` in fp32, cast to x's type, coef read from device memory.
  Bound: memory, n·(2·sizeof x + sizeof a) bytes.

The first three carry the flat engine's stage; the last two carry the tree
path (``core/pullpush.py``), one call per (worker, leaf), where x is a
worker's leaf row in the model's dtype and a the fp32 center.

Design against that bound: one pass over the view per kernel, 16-byte
loads with neighbouring threads on neighbouring columns, the R x R sums in
registers, no padded copy of the (R, n) matrix (the reference pads it,
which at the main path's width would be 19.5 GB of extra traffic), and
``out=flat`` writes the mix in place.

Every wrapper checks its inputs before it dispatches, on any device.
For tensors on the CPU it runs the plain version from ``ref.py``; for a
CUDA tensor it launches the kernel or raises — there is no fallback; on
the ``meta`` device (launch analysis, ``launch/roofline.py``) it launches
nothing: it returns empty outputs of the kernel's shapes and records each
launch, and each wrapper ``LAUNCHES`` counts, with the active
``launch.census.Census``, at its ``cost()``. The
shared library is built from ``csrc/pullpush.cu`` with ``nvcc`` on first
CUDA use (``build()``, through ``kernels/_build.py``), never at import.
``LAUNCHES`` counts kernel launches per kernel; ``fused_round``,
``fused_round_sharded``, ``mix_from_gram`` and ``sq_dist`` count their
calls (each is more than one launch, or a launch counted under
``mix_shard`` / ``stale_mix``).
"""
from __future__ import annotations

import contextlib
import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.launch.census import record_kernel
from repro_torch.kernels.pullpush.ref import (
    apply_plain, fused_round_leaves_plain, fused_round_plain,
    fused_round_sharded_plain, gram_coef_plain, gram_sum_plain,
    mix_from_gram_plain, mix_shard_plain, partial_gram_plain, sq_dist_plain,
    stale_mix_plain,
)

MAX_ROWS = 32          # the kernels keep one column of every row in registers
THREADS = 256          # kThreads in csrc/pullpush.cu
BLOCKS_PER_SM = 8      # grid of the two streaming kernels: 8 x 256 threads/SM

NUM_SMS = 132          # H100 SXM: the grid a trace on meta assumes
GROUP = 8              # kGroup: elements a thread step of the vector kernels
# dtype codes of the C interface of sq_dist / apply_update
PAIR_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"fused_round": 0, "partial_gram": 0, "gram_coef": 0,
            "mix_shard": 0, "mix_from_gram": 0, "stale_mix": 0,
            "fused_round_sharded": 0, "leaf_gram": 0, "leaf_mix": 0,
            "sq_dist": 0, "apply_update": 0}


def _bind(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f32 = ctypes.c_float
    # (..., ticket, T, c0, c1, eps, G, r, coef, stream)
    tail = [vp, vp, vp, vp, f32, vp, vp, vp, vp]
    lib.pp_partial_gram.argtypes = [vp, i32, i64, i64, vp, i32, i32] + tail
    lib.pp_leaf_gram.argtypes = [vp, i32, i32, i64, vp, i32, i32] + tail
    lib.pp_gram_coef.argtypes = [vp, i32, i32, vp, vp, vp, f32, vp, vp, vp,
                                 vp]
    lib.pp_mix.argtypes = [vp, i32, i64, vp, vp, vp, i32, i32, vp]
    lib.pp_stale_mix.argtypes = [vp, i32, i64, vp, vp, vp, vp, i32, i32, vp]
    lib.pp_mix_from_gram.argtypes = [vp, i32, i64, vp, vp, vp, vp, f32, vp,
                                     vp, vp, vp, i32, i32, vp]
    lib.pp_leaf_mix.argtypes = [vp, i32, i32, i64, vp, vp, i32, i32, vp]
    lib.pp_sq_dist.argtypes = [vp, i32, vp, i32, i64, vp, i32, i32, vp, vp]
    lib.pp_apply.argtypes = [vp, i32, vp, i32, vp, vp, i64, i32, i32, vp]
    for fn in (lib.pp_partial_gram, lib.pp_leaf_gram, lib.pp_gram_coef,
               lib.pp_mix, lib.pp_stale_mix, lib.pp_mix_from_gram,
               lib.pp_leaf_mix, lib.pp_sq_dist, lib.pp_apply):
        fn.restype = i32
    lib.pp_error_string.argtypes = [i32]
    lib.pp_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.pp_error_string


# five units (pullpush.cu's PP_PARTS): its entry points' instances, one
# nvcc ~1 min on an H100 host, compiled side by side
SOURCE = _build.Source("pullpush", Path(__file__).resolve().parent / "csrc"
                       / "pullpush.cu", _bind, parts=5)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def cost(kernel, R, n, *, base=False, nblk=1, leaf_bytes=0, x_bytes=4,
         a_bytes=4):
    """The work of one call of ``kernel`` (a ``LAUNCHES`` name) on an (R,
    n) fp32 view: ``{"flops", "bytes"}``, the bytes it must move (each
    input read once, each output written once) and its fp32 operations.
    ``chip_smoke.py``'s bounds divide them by the card's rates. ``base``:
    the stale epilogue's variant (q read too); ``nblk``: ``gram_coef``'s
    partial Grams; ``leaf_bytes``: the tree of ``leaf_gram`` /
    ``leaf_mix`` (whose (R, n) is its virtual view); ``x_bytes`` /
    ``a_bytes``: the element sizes of ``sq_dist`` / ``apply_update``'s
    (n,) vectors."""
    small = 4 * (R * R + 3 * R)              # T, c0 / c1 / coef, r
    gram = R * R * 4
    k = 3 if base else 2                     # (R, n) passes of a mix
    table = {
        "fused_round": (k * R * n * 4 + small + gram,
                        2 * R * R * n + k * R * R * n),
        "fused_round_sharded": ((k + 1) * R * n * 4,
                                2 * R * R * n + k * R * R * n),
        "partial_gram": (R * n * 4 + gram, 2 * R * R * n),
        "gram_coef": (nblk * gram + small + gram, nblk * R * R + 4 * R ** 3),
        "mix_shard": (2 * R * n * 4 + small, 2 * R * R * n),
        "stale_mix": (3 * R * n * 4 + small, 3 * R * R * n),
        "mix_from_gram": (k * R * n * 4 + small + gram, k * R * R * n),
        "leaf_gram": (leaf_bytes + small + gram, 2 * R * R * n),
        "leaf_mix": (2 * leaf_bytes + small, 2 * R * R * n),
        "sq_dist": (n * (x_bytes + a_bytes), 3 * n),
        "apply_update": (n * (2 * x_bytes + a_bytes), 3 * n),
    }
    if kernel not in table:
        raise ValueError(f"unknown kernel {kernel!r}")
    nbytes, flops = table[kernel]
    return {"flops": flops, "bytes": nbytes}


def _count(name, t, work):
    """One call of wrapper ``name`` on ``t``'s device: counted in
    ``LAUNCHES`` on the card, recorded with the census on meta."""
    if t.device.type == "meta":
        record_kernel(name, work)
    else:
        LAUNCHES[name] += 1


def _on(t):
    """The device context of a launch: the card's, or none on meta."""
    return torch.cuda.device(t.device) if t.is_cuda \
        else contextlib.nullcontext()


def build():
    """Compile ``csrc/pullpush.cu`` (once per source hash) and load it
    (``kernels/_build.py``). Returns the ``ctypes.CDLL``;
    ``_build.build_info["pullpush"]`` records the build."""
    return _build.build(SOURCE)[0]


# ---------------------------------------------------------------------------
# argument checks (both devices) and launch plumbing (CUDA)
# ---------------------------------------------------------------------------

def _check_flat(flat, name="flat", *, strided=False):
    """``strided``: a column chunk ``x[:, a:b]`` of a row-major view is
    taken in place (unit column stride, rows ``flat.stride(0)`` apart)."""
    if not isinstance(flat, torch.Tensor) or flat.dim() != 2:
        raise ValueError(f"{name} must be a 2-D (R, n) tensor")
    if flat.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {flat.dtype}")
    if strided:
        if flat.stride(1) != 1 or (flat.shape[0] > 1
                                   and flat.stride(0) < flat.shape[1]):
            raise ValueError(f"{name} must be row-major with unit column "
                             "stride (a column chunk of an (R, n) view)")
    elif not flat.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major (R, n))")
    R, n = flat.shape
    if not 1 <= R <= MAX_ROWS:
        raise ValueError(f"{name} has {R} rows; the kernels take "
                         f"1..{MAX_ROWS}")
    if n < 1:
        raise ValueError(f"{name} has no columns")
    if flat.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {flat.device}")


def _small(v, shape, flat):
    """T / c0 / c1 / coef as contiguous fp32 on flat's device; scalars
    broadcast to ``shape``."""
    t = torch.as_tensor(v, dtype=torch.float32, device=flat.device)
    if t.shape != shape:
        if t.dim() > len(shape):
            raise ValueError(f"expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        t = t.expand(shape)
    return t.contiguous()


def _aliased(a, b):
    """``a`` shares ``b``'s storage without being ``b`` itself: a shifted
    view, whose rows a thread would write before others read them."""
    return a.data_ptr() != b.data_ptr() and \
        a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _check_out(out, flat, base=None):
    """``out`` may be ``flat`` (or the stale epilogue's ``base``) itself,
    or lie in another buffer."""
    if out is None:
        return torch.empty_like(flat)
    if out.shape != flat.shape or out.dtype != torch.float32 \
            or out.device != flat.device or not out.is_contiguous():
        raise ValueError("out must be a contiguous float32 tensor of the "
                         "same shape and device as flat")
    if _aliased(out, flat) or (base is not None and _aliased(out, base)):
        raise ValueError("out must be flat itself or lie in another buffer")
    return out


def _ld(t):
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def _vec(*tensors, want=None):
    """float4 loads need 16-byte aligned rows: n and the row stride
    multiples of 4 and aligned base pointers; the 16- and 32-row buckets
    load one float per row. ``want=4`` asks for float4 and raises where
    the tensors do not allow it (before any build or launch)."""
    R, n = tensors[0].shape
    ok = R <= 8 and n % 4 == 0 and all(
        _ld(t) % 4 == 0 and t.data_ptr() % 16 == 0 for t in tensors)
    if want == 4 and not ok:
        raise ValueError("float4 loads need R <= 8, n and the row stride "
                         "multiples of 4 and 16-byte aligned rows")
    return want or (4 if ok else 1)


_SM_COUNT = {}


def _blocks(device, groups):
    """Grid of a grid-stride kernel over ``groups`` thread steps: one
    step a thread, at most BLOCKS_PER_SM blocks of THREADS a multiprocessor."""
    if device.type == "meta":
        return max(1, min(-(-groups // THREADS), BLOCKS_PER_SM * NUM_SMS))
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return max(1, min(-(-groups // THREADS), BLOCKS_PER_SM * _SM_COUNT[dev]))


def _grid(flat, vec):
    return _blocks(flat.device, flat.shape[1] // vec)


def workspace_blocks(flat):
    """Number of partial Grams the first launch of ``fused_round`` writes
    for this CUDA tensor (the leading dim of ``gram_coef``'s input)."""
    _check_flat(flat, strided=True)
    return _grid(flat, _vec(flat))


_stream, _ptr = _build.stream, _build.ptr


def _raise_if(code, what):
    _build.raise_if(build(), code, what)


_TICKETS = {}


def _ticket(t):
    """The partial-Gram tail's ticket for PyTorch's current stream on t's
    device: one zeroed unsigned int a stream, which the last block sets
    back to 0, so launches on one stream take turns with it and launches
    on two streams never share one."""
    key = (t.device.index, torch.cuda.current_stream(t.device).cuda_stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros((1,), dtype=torch.int32, device=t.device)
    return _TICKETS[key]


def _opt(t):
    return ctypes.c_void_p(None) if t is None else _ptr(t)


def _coef_outputs(R, device):
    """G, r and coef of the coefficient phase, fresh."""
    f = dict(dtype=torch.float32, device=device)
    return (torch.empty((R, R), **f), torch.empty((R,), **f),
            torch.empty((R,), **f))


def _launch_partial_gram(flat, vec, T=None, c0=None, c1=None, eps=1e-12,
                         *, tail=True):
    """The partial-Gram kernel. With ``tail`` its last block sums the
    block partials into G and, given T, computes r and coef: returns
    ``(G, r, coef)`` (r and coef None without T). Without, the (nblk, R,
    R) workspace of block partials, for ``gram_coef``."""
    R, n = flat.shape
    nblk = _grid(flat, vec)
    ws = torch.empty((nblk, R, R), dtype=torch.float32, device=flat.device)
    G = r = coef = ticket = None
    if tail:
        G, r, coef = _coef_outputs(R, flat.device)
        if T is None:
            r = coef = None
    if flat.device.type == "meta":
        record_kernel("partial_gram", cost("partial_gram", R, n),
                      (flat, T, c0, c1), (G, r, coef) if tail else (ws,))
        return (G, r, coef) if tail else ws
    lib = build()
    if tail:
        ticket = _ticket(flat)
    LAUNCHES["partial_gram"] += 1
    _raise_if(lib.pp_partial_gram(
        _ptr(flat), R, n, _ld(flat), _ptr(ws), nblk, vec, _opt(ticket),
        _opt(T), _opt(c0), _opt(c1), float(eps), _opt(G), _opt(r),
        _opt(coef), _stream(flat)), "partial_gram")
    return (G, r, coef) if tail else ws


def _launch_gram_coef(ws, T=None, c0=None, c1=None, eps=1e-12):
    """Fixed-order sum of the partials into G; with T also r and coef."""
    nblk, R, _ = ws.shape
    G, r, coef = _coef_outputs(R, ws.device)
    if ws.device.type == "meta":
        record_kernel("gram_coef", cost("gram_coef", R, 0, nblk=nblk),
                      (ws, T, c0, c1), (G, r, coef))
        return G, r, coef
    lib = build()
    LAUNCHES["gram_coef"] += 1
    _raise_if(lib.pp_gram_coef(
        _ptr(ws), nblk, R, _opt(T), _opt(c0), _opt(c1), float(eps), _ptr(G),
        _ptr(r), _ptr(coef), _stream(ws)), "gram_coef")
    return G, r, coef


def _launch_mix(flat, T, coef, out, base=None):
    """``mix_shard``'s kernel, or with ``base`` the stale epilogue's."""
    R, n = flat.shape
    if flat.device.type == "meta":
        name = "mix_shard" if base is None else "stale_mix"
        record_kernel(name, cost(name, R, n), (flat, T, coef, base), (out,))
        return out
    lib = build()
    vec = _vec(*(t for t in (flat, out, base) if t is not None))
    nblk = _grid(flat, vec)
    if base is None:
        LAUNCHES["mix_shard"] += 1
        _raise_if(lib.pp_mix(_ptr(flat), R, n, _ptr(T), _ptr(coef),
                             _ptr(out), nblk, vec, _stream(flat)),
                  "mix_shard")
    else:
        LAUNCHES["stale_mix"] += 1
        _raise_if(lib.pp_stale_mix(_ptr(flat), R, n, _ptr(T), _ptr(coef),
                                   _ptr(base), _ptr(out), nblk, vec,
                                   _stream(flat)), "stale_mix")
    return out


def _launch_mix_from_gram(flat, T, c0, c1, G, eps, out, base=None):
    """The mix (or with ``base`` the stale epilogue) whose blocks compute
    the coefficients from the given Gram G in their prologue: one launch,
    counted as ``mix_shard`` / ``stale_mix``. Returns ``(r, coef)``."""
    R, n = flat.shape
    _, r, coef = _coef_outputs(R, flat.device)
    name = "mix_shard" if base is None else "stale_mix"
    if flat.device.type == "meta":
        record_kernel(name, cost("mix_from_gram", R, n,
                                 base=base is not None),
                      (flat, T, G, c0, c1, base), (out, r, coef))
        return r, coef
    lib = build()
    vec = _vec(*(t for t in (flat, out, base) if t is not None))
    nblk = _grid(flat, vec)
    LAUNCHES[name] += 1
    _raise_if(lib.pp_mix_from_gram(
        _ptr(flat), R, n, _ptr(T), _ptr(G), _ptr(c0), _ptr(c1), float(eps),
        _opt(base), _ptr(out), _ptr(r), _ptr(coef), nblk, vec,
        _stream(flat)), name)
    return r, coef


# ---------------------------------------------------------------------------
# public wrappers (the reference's signatures, minus the TPU block knobs)
# ---------------------------------------------------------------------------

def _check_base(base, flat):
    """The stale epilogue's fresh view: flat's shape, contiguous fp32 on
    flat's device, in another buffer."""
    if base is None:
        return None
    if not isinstance(base, torch.Tensor) or base.shape != flat.shape \
            or base.dtype != torch.float32 or base.device != flat.device \
            or not base.is_contiguous():
        raise ValueError("base must be a contiguous float32 tensor of the "
                         "same shape and device as flat")
    if _aliased(base, flat):
        raise ValueError("base must lie in another buffer than flat")
    return base


def fused_round(flat, T, c0, c1, eps=1e-12, out=None, base=None):
    """One consensus stage over the flat (R, n) worker matrix.

    Per row i: ``r_i = ||x_i - T_i x||``, ``coef_i = c0_i + c1_i /
    max(r_i, eps)``, ``out_i = T_i x + (1 - coef_i)(x_i - T_i x)``.
    ``T`` must be row-stochastic. ``out`` may be ``flat`` (in place).
    With ``base`` (a fresh (R, n) view q) the last launch is the stale
    epilogue: ``out = q + (mix(flat) - flat)``; ``out`` may then be
    ``flat`` or ``base``. Returns ``(out, r, G)``; G is the block-centered
    Gram, so only its zero-sum quadratic forms mean anything.
    """
    _check_flat(flat)
    R = flat.shape[0]
    T = _small(T, (R, R), flat)
    c0 = _small(c0, (R,), flat)
    c1 = _small(c1, (R,), flat)
    base = _check_base(base, flat)
    out = _check_out(out, flat, base)
    if flat.device.type == "cpu":
        if base is None:
            return fused_round_plain(flat, T, c0, c1, eps, out=out)
        G = partial_gram_plain(flat)
        return mix_from_gram_plain(flat, T, c0, c1, G, eps, out=out,
                                   base=base)
    _count("fused_round", flat, cost("fused_round", R, flat.shape[1],
                                     base=base is not None))
    with _on(flat):
        G, r, coef = _launch_partial_gram(flat, _vec(flat), T, c0, c1, eps)
        _launch_mix(flat, T, coef, out, base)
    return out, r, G


def fused_round_sharded(flat, T, c0, c1, *, group, eps=1e-12, out=None,
                        base=None):
    """One consensus stage on this rank's (R, n_local) column shard of the
    flat view: the block-centered partial Gram, its sum over ``group``
    (a ``launch.mesh.Group``, the column group), then ``r``, ``coef`` and
    the mix of the shard (the stale epilogue with ``base``, as in
    ``fused_round``). Every rank of the group gets the same Gram, ``r``
    and coefficients. ``out`` may be ``flat`` (in place). Returns ``(out,
    r, G)`` with the completed Gram."""
    from repro_torch.launch.mesh import all_reduce
    _check_flat(flat)
    R = flat.shape[0]
    T = _small(T, (R, R), flat)
    c0 = _small(c0, (R,), flat)
    c1 = _small(c1, (R,), flat)
    base = _check_base(base, flat)
    out = _check_out(out, flat, base)
    reduce = lambda G: all_reduce(G, group)
    if flat.device.type == "cpu":
        return fused_round_sharded_plain(flat, T, c0, c1, reduce, eps,
                                         out=out, base=base)
    _count("fused_round_sharded", flat,
           cost("fused_round_sharded", R, flat.shape[1],
                base=base is not None))
    with _on(flat):
        G, _, _ = _launch_partial_gram(flat, _vec(flat))
        G = reduce(G)
        r, _ = _launch_mix_from_gram(flat, T, c0, c1, G, eps, out, base)
    return out, r, G


def partial_gram(flat, *, vec=None):
    """Block-centered Gram of a (R, n_local) column shard, or of a column
    chunk ``x[:, a:b]`` of a row-major view, read in place. The partial
    Grams of disjoint chunks add up to a Gram with the same zero-sum
    forms as the full-width one. ``vec=4`` insists on 16-byte loads and
    raises where the chunk's alignment does not allow them."""
    _check_flat(flat, strided=True)
    vec = _vec(flat, want=vec)
    if flat.device.type == "cpu":
        return partial_gram_plain(flat)
    with _on(flat):
        G, _, _ = _launch_partial_gram(flat, vec)
    return G


def gram_coef(ws, T, c0, c1, eps=1e-12):
    """The coefficient phase on its own: sum a (nblk, R, R) stack of
    partial Grams in a fixed order (``ref.gram_sum_plain``'s) into G,
    then ``r`` and ``coef`` as in ``fused_round``, in one block. The
    stages run the same code in the partial-Gram tail or the mix
    prologue. Returns ``(G, r, coef)``."""
    if not isinstance(ws, torch.Tensor) or ws.dim() != 3 \
            or ws.shape[1] != ws.shape[2] or ws.dtype != torch.float32:
        raise ValueError("ws must be a float32 (nblk, R, R) tensor")
    R = ws.shape[-1]
    _check_flat(ws[0])
    T = _small(T, (R, R), ws)
    c0 = _small(c0, (R,), ws)
    c1 = _small(c1, (R,), ws)
    if ws.device.type == "cpu":
        G = gram_sum_plain(ws)
        return (G, *gram_coef_plain(G, T, c0, c1, eps))
    with _on(ws):
        return _launch_gram_coef(ws.contiguous(), T, c0, c1, eps)


def mix_shard(flat, T, coef, out=None):
    """``out_i = x_i + coef_i (T_i x - x_i)`` on a (R, n_local) shard with
    precomputed coefficients (uniform gap form). ``out`` may be ``flat``."""
    _check_flat(flat)
    R = flat.shape[0]
    T = _small(T, (R, R), flat)
    coef = _small(coef, (R,), flat)
    out = _check_out(out, flat)
    if flat.device.type == "cpu":
        return mix_shard_plain(flat, T, coef, out=out)
    with _on(flat):
        return _launch_mix(flat, T, coef, out)


def stale_mix(flat, T, coef, base, out=None):
    """The overlap modes' stale epilogue in one pass: ``out = base +
    (mix_shard(flat) - flat)`` — the consensus delta of the snapshot
    ``flat`` applied to the fresh view ``base`` (q), with every operation
    rounded as ``ref.py::stale_mix_plain`` does. ``out`` may be ``flat``
    or ``base`` (in place)."""
    _check_flat(flat)
    R = flat.shape[0]
    T = _small(T, (R, R), flat)
    coef = _small(coef, (R,), flat)
    base = _check_base(base, flat)
    if base is None:
        raise ValueError("stale_mix needs a base view")
    out = _check_out(out, flat, base)
    if flat.device.type == "cpu":
        return stale_mix_plain(flat, T, coef, base, out=out)
    with _on(flat):
        return _launch_mix(flat, T, coef, out, base)


def mix_from_gram(flat, T, c0, c1, G, eps=1e-12, out=None, base=None):
    """A consensus stage whose column contraction already happened: ``G``
    is a completed block-centered (or plain) Gram, e.g. the sum of
    per-chunk ``partial_gram`` calls. One ``mix_shard`` launch, or with
    ``base`` one ``stale_mix`` launch (``out = base + (mix(flat) -
    flat)``), whose blocks compute ``r`` and ``coef`` from G first, as
    ``gram_coef`` does on G as a one-block workspace. ``out`` defaults to a new buffer and may be ``flat`` (or
    ``base``). Returns ``(out, r, G)`` like ``fused_round``."""
    _check_flat(flat)
    R = flat.shape[0]
    G = _small(G, (R, R), flat)
    T = _small(T, (R, R), flat)
    c0 = _small(c0, (R,), flat)
    c1 = _small(c1, (R,), flat)
    base = _check_base(base, flat)
    out = _check_out(out, flat, base)
    if flat.device.type == "cpu":
        return mix_from_gram_plain(flat, T, c0, c1, G, eps, out=out,
                                   base=base)
    _count("mix_from_gram", flat, cost("mix_from_gram", R, flat.shape[1],
                                       base=base is not None))
    with _on(flat):
        r, _ = _launch_mix_from_gram(flat, T, c0, c1, G, eps, out, base)
    return out, r, G


# ---------------------------------------------------------------------------
# the stage on a worker-stacked tree's own leaves (pullpush_fused)
# ---------------------------------------------------------------------------

LEAF_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COPY_STREAMS = {}     # device index -> the leaf tables' copy stream
LEAF_FIELDS = 5        # kLeafFields: src, dst, size, off, bf16


@dataclass(frozen=True)
class LeafTable:
    """The virtual (M, n) view of a worker-stacked tree, as the flatten
    order lays it out: leaf i holds columns ``offsets[i]`` ..
    ``offsets[i] + sizes[i] - 1``; ``bf16[i]`` is its dtype flag (1
    bfloat16, 0 float32). ``vec``: the columns a thread step of the leaf
    kernels, ``_vec`` of a fresh (M, n) fp32 view, so that they run
    ``fused_round``'s grid and column-to-thread map on it."""
    M: int
    n: int
    vec: int
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    bf16: Tuple[int, ...]

    def packed(self, srcs, dsts):
        """The (L, 5) int64 rows ``(src, dst, size, off, bf16)`` of the
        leaves with elements, on the leaves' device. On the card the copy
        runs on a stream of its own, which the current stream waits for
        on the device: a copy from pageable memory may wait for its
        stream's queue, and the current one holds the last call's passes."""
        rows = torch.tensor(
            [(s.data_ptr(), d.data_ptr(), size, off, flag)
             for s, d, size, off, flag in zip(
                 srcs, dsts, self.sizes, self.offsets, self.bf16) if size],
            dtype=torch.int64)
        dev = srcs[0].device
        if dev.type != "cuda":
            return rows
        key = dev.index
        if key not in _COPY_STREAMS:
            _COPY_STREAMS[key] = torch.cuda.Stream(dev)
        side, main = _COPY_STREAMS[key], torch.cuda.current_stream(dev)
        with torch.cuda.stream(side):
            tab = rows.to(dev, non_blocking=True)
        main.wait_stream(side)
        tab.record_stream(main)
        return tab


def leaf_table(leaves):
    """Check the leaves of a worker-stacked tree (each (M, ...), float32 or
    bfloat16, all on one device, 1 <= M <= 32) and lay out their virtual
    (M, n) view."""
    if not leaves or not all(isinstance(l, torch.Tensor) and l.dim() >= 1
                             for l in leaves):
        raise ValueError("expected the (M, ...) leaves of a worker-stacked "
                         "tree")
    for l in leaves:
        if l.dtype not in LEAF_DTYPES:
            raise TypeError(f"leaves must be float32 or bfloat16, got "
                            f"{l.dtype}")
    dev = leaves[0].device
    if any(l.device != dev for l in leaves):
        raise ValueError("the leaves lie on different devices")
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    M = leaves[0].shape[0]
    if any(l.shape[0] != M for l in leaves):
        raise ValueError("the leaves stack different numbers of workers")
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"{M} workers; the kernels take 1..{MAX_ROWS}")
    sizes = tuple(l[0].numel() for l in leaves)
    offsets, o = [], 0
    for size in sizes:
        offsets.append(o)
        o += size
    if o < 1:
        raise ValueError("the leaves have no columns")
    return LeafTable(M=M, n=o, vec=4 if M <= 8 and o % 4 == 0 else 1,
                     offsets=tuple(offsets), sizes=sizes,
                     bf16=tuple(LEAF_DTYPES[l.dtype] for l in leaves))


def _leaf_launches(leaves, table, T, c0, c1, eps):
    """The two leaf launches on one prepared table, as two calls ``gram()``
    and ``mix()`` (counted by the caller), and what they write: returns
    ``(gram, mix, outs, r, G)``. Every tensor a launch reads stays alive
    with the closures."""
    lib = build()
    M, dev = table.M, leaves[0].device
    srcs = [l.contiguous() for l in leaves]
    outs = [torch.empty(l.shape, dtype=l.dtype, device=dev) for l in leaves]
    tab = table.packed(srcs, outs)
    rows = tab.shape[0]
    nblk = _blocks(dev, table.n // table.vec)
    ws = torch.empty((nblk, M, M), dtype=torch.float32, device=dev)
    G, r, coef = _coef_outputs(M, dev)
    ticket = _ticket(ws)

    def gram():
        _raise_if(lib.pp_leaf_gram(
            _ptr(tab), rows, M, table.n, _ptr(ws), nblk, table.vec,
            _ptr(ticket), _ptr(T), _ptr(c0), _ptr(c1), float(eps), _ptr(G),
            _ptr(r), _ptr(coef), _stream(ws)), "leaf_gram")

    def mix():
        _raise_if(lib.pp_leaf_mix(
            _ptr(tab), rows, M, table.n, _ptr(T), _ptr(coef), nblk,
            table.vec, _stream(ws)), "leaf_mix")
    return gram, mix, outs, r, G


def fused_round_leaves(leaves, T, c0, c1, eps=1e-12):
    """``fused_round`` on the virtual (M, n) view of a worker-stacked
    tree's leaves (each (M, ...), float32 or bfloat16), read in place:
    two launches, the partial Gram (with its coefficient tail) and the
    mix, which rounds each result to its leaf's dtype into a new leaf.
    The same bits as ``fused_round`` on the flattened fp32 view followed
    by a cast of each leaf's columns, without making that view. Returns
    ``(new leaves, r, G)``."""
    table = leaf_table(leaves)
    M = table.M
    T = _small(T, (M, M), leaves[0])
    c0 = _small(c0, (M,), leaves[0])
    c1 = _small(c1, (M,), leaves[0])
    if leaves[0].device.type == "cpu":
        return fused_round_leaves_plain(leaves, T, c0, c1, eps)
    if leaves[0].device.type == "meta":
        outs = [torch.empty_like(l) for l in leaves]
        G, r, coef = _coef_outputs(M, leaves[0].device)
        tree = sum(l.numel() * l.element_size() for l in leaves)
        record_kernel("leaf_gram", cost("leaf_gram", M, table.n,
                                        leaf_bytes=tree),
                      (*leaves, T, c0, c1), (G, r, coef))
        record_kernel("leaf_mix", cost("leaf_mix", M, table.n,
                                       leaf_bytes=tree),
                      (*leaves, T, coef), outs)
        return outs, r, G
    with torch.cuda.device(leaves[0].device):
        gram, mix, outs, r, G = _leaf_launches(leaves, table, T, c0, c1, eps)
        LAUNCHES["leaf_gram"] += 1
        gram()
        LAUNCHES["leaf_mix"] += 1
        mix()
    return outs, r, G


# ---------------------------------------------------------------------------
# the tree path's per-vector pair
# ---------------------------------------------------------------------------

def _check_vec(v, name):
    if not isinstance(v, torch.Tensor) or v.dim() != 1:
        raise ValueError(f"{name} must be a 1-D (n,) tensor")
    if v.dtype not in PAIR_DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {v.dtype}")
    if not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if v.numel() < 1:
        raise ValueError(f"{name} is empty")
    if v.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {v.device}")


def _check_pair(x, a):
    _check_vec(x, "x")
    _check_vec(a, "a")
    if a.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} and a {tuple(a.shape)} differ")
    if a.device != x.device:
        raise ValueError("x and a lie on different devices")


def _vec8(x, a):
    """8-element groups as 16-byte loads need both base pointers aligned;
    any other offset takes the element-wise kernel."""
    return x.data_ptr() % 16 == 0 and a.data_ptr() % 16 == 0


def sq_dist(x, a):
    """``Σ (x − a)²`` of two (n,) vectors (each float32 or bfloat16) with
    fp32 accumulation: a () float32 tensor on x's device. On the card the
    sum runs in a fixed order, so repeated calls agree bit for bit."""
    _check_pair(x, a)
    if x.device.type == "cpu":
        return sq_dist_plain(x, a)
    if x.device.type == "meta":
        out = torch.empty((), dtype=torch.float32, device="meta")
        record_kernel("sq_dist", cost("sq_dist", 1, x.numel(),
                                      x_bytes=x.element_size(),
                                      a_bytes=a.element_size()),
                      (x, a), (out,))
        return out
    lib = build()
    n = x.numel()
    vec8 = _vec8(x, a)
    nblk = _blocks(x.device, n // GROUP if vec8 else n)
    partials = torch.empty((nblk,), dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    LAUNCHES["sq_dist"] += 1
    with torch.cuda.device(x.device):
        _raise_if(lib.pp_sq_dist(
            _ptr(x), PAIR_DTYPES[x.dtype], _ptr(a), PAIR_DTYPES[a.dtype], n,
            _ptr(partials), nblk, int(vec8), _ptr(out), _stream(x)),
            "sq_dist")
    return out


def _coef(coef, x):
    """A python float as a one-element fp32 tensor on x's device; a tensor
    must already be one fp32 element there (the kernel reads it from
    device memory)."""
    if not isinstance(coef, torch.Tensor):
        return torch.full((1,), float(coef), dtype=torch.float32,
                          device=x.device)
    if coef.numel() != 1 or coef.dtype != torch.float32 \
            or coef.device != x.device:
        raise ValueError("coef must be a python float or one float32 "
                         "element on x's device")
    return coef


def _check_vec_out(out, x, a):
    if out is None:
        return torch.empty_like(x)
    _check_vec(out, "out")
    if out.shape != x.shape or out.dtype != x.dtype \
            or out.device != x.device:
        raise ValueError("out must have x's shape, dtype and device")
    if out.data_ptr() != x.data_ptr() and any(
            out.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
            for t in (x, a)):
        # a shifted alias would be written before other threads read it
        raise ValueError("out must be x itself or lie in another buffer "
                         "than x and a")
    return out


def apply_update(x, a, coef, *, out=None):
    """``x + (a − x)·coef`` in fp32, cast to x's dtype. x, a: (n,) float32
    or bfloat16; coef: a python float or one float32 element on x's
    device. ``out`` may be ``x`` (in place)."""
    _check_pair(x, a)
    coef = _coef(coef, x)
    out = _check_vec_out(out, x, a)
    if x.device.type == "cpu":
        return apply_plain(x, a, coef, out=out)
    if x.device.type == "meta":
        record_kernel("apply_update", cost("apply_update", 1, x.numel(),
                                           x_bytes=x.element_size(),
                                           a_bytes=a.element_size()),
                      (x, a, coef), (out,))
        return out
    lib = build()
    n = x.numel()
    vec8 = _vec8(x, a) and out.data_ptr() % 16 == 0
    nblk = _blocks(x.device, n // GROUP if vec8 else n)
    LAUNCHES["apply_update"] += 1
    with torch.cuda.device(x.device):
        _raise_if(lib.pp_apply(
            _ptr(x), PAIR_DTYPES[x.dtype], _ptr(a), PAIR_DTYPES[a.dtype],
            _ptr(coef), _ptr(out), n, nblk, int(vec8), _stream(x)),
            "apply_update")
    return out

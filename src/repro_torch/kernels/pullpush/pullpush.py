"""Hopper kernels for the DPPF consensus stage, and their wrappers.

Replaces ``src/repro/kernels/pullpush/pullpush.py``:

* ``fused_round`` ← ``fused_round`` (``_fused_round_kernel``): one
  consensus stage. The TPU's single two-phase ``pallas_call`` becomes three
  launches on the current stream — ``partial_gram``, ``gram_coef``,
  ``mix_shard`` — because Hopper blocks cannot wait on each other the way
  TPU grid steps run in order (``csrc/pullpush.cu`` says how).
* ``partial_gram`` ← ``partial_gram`` (``_partial_gram_kernel``):
  block-centered Gram of a column shard. Bound: memory, R·n·4 bytes read.
* ``mix_shard`` ← ``mix_shard`` (``_mix_kernel``): the uniform gap-form
  mix with given coefficients. Bound: memory, 2·R·n·4 bytes (read +
  write).

Design against that bound: one pass over the view per kernel, 16-byte
loads with neighbouring threads on neighbouring columns, the R x R sums in
registers, no padded copy of the (R, n) matrix (the reference pads it,
which at the main path's width would be 19.5 GB of extra traffic), and
``out=flat`` writes the mix in place.

Every wrapper checks its inputs before it dispatches, on either device.
For tensors on the CPU it runs the plain version from ``ref.py``; for a
CUDA tensor it launches the kernel or raises — there is no fallback. The
shared library is built from ``csrc/pullpush.cu`` with ``nvcc`` on first
CUDA use (``build()``), never at import. ``LAUNCHES`` counts kernel
launches per kernel; ``fused_round`` counts its calls.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.kernels.pullpush.ref import (
    fused_round_plain, gram_coef_plain, mix_shard_plain, partial_gram_plain,
)

MAX_ROWS = 32          # the kernels keep one column of every row in registers
THREADS = 256          # kThreads in csrc/pullpush.cu
BLOCKS_PER_SM = 8      # grid of the two streaming kernels: 8 x 256 threads/SM

LAUNCHES = {"fused_round": 0, "partial_gram": 0, "gram_coef": 0,
            "mix_shard": 0}

_SRC = Path(__file__).resolve().parent / "csrc" / "pullpush.cu"
# <repo>/build/repro_torch: listed in .gitignore
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_info = {}        # seconds, ptxas log and path of the last build()


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the pull-push kernels are built "
                           "from csrc/pullpush.cu at first CUDA use")
    return path


def build():
    """Compile ``csrc/pullpush.cu`` (once per source hash) and load it.
    Returns the ``ctypes.CDLL``; ``build_info`` records the build seconds
    and the ptxas register / spill report."""
    global _lib
    if _lib is not None:
        return _lib
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"libpullpush-{tag}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                               str(_SRC)], capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)         # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(so))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pp_partial_gram.argtypes = [vp, i32, i64, vp, i32, i32, vp]
    lib.pp_gram_coef.argtypes = [vp, i32, i32, vp, vp, vp, ctypes.c_float,
                                 vp, vp, vp, vp]
    lib.pp_mix.argtypes = [vp, i32, i64, vp, vp, vp, i32, i32, vp]
    for fn in (lib.pp_partial_gram, lib.pp_gram_coef, lib.pp_mix):
        fn.restype = i32
    lib.pp_error_string.argtypes = [i32]
    lib.pp_error_string.restype = ctypes.c_char_p
    build_info.update(seconds=time.perf_counter() - t0, log=log,
                      path=str(so))
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# argument checks (both devices) and launch plumbing (CUDA)
# ---------------------------------------------------------------------------

def _check_flat(flat, name="flat"):
    if not isinstance(flat, torch.Tensor) or flat.dim() != 2:
        raise ValueError(f"{name} must be a 2-D (R, n) tensor")
    if flat.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {flat.dtype}")
    if not flat.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major (R, n))")
    R, n = flat.shape
    if not 1 <= R <= MAX_ROWS:
        raise ValueError(f"{name} has {R} rows; the kernels take "
                         f"1..{MAX_ROWS}")
    if n < 1:
        raise ValueError(f"{name} has no columns")
    if flat.device.type not in ("cpu", "cuda"):
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


def _check_out(out, flat):
    if out is None:
        return torch.empty_like(flat)
    if out.shape != flat.shape or out.dtype != torch.float32 \
            or out.device != flat.device or not out.is_contiguous():
        raise ValueError("out must be a contiguous float32 tensor of the "
                         "same shape and device as flat")
    if out.data_ptr() != flat.data_ptr() and \
            out.untyped_storage().data_ptr() == \
            flat.untyped_storage().data_ptr():
        # a column's rows would be written before other threads read them
        raise ValueError("out must be flat itself or lie in another buffer")
    return out


def _vec(*tensors):
    """float4 loads need 16-byte aligned rows: n % 4 == 0 and aligned
    base pointers; the 16- and 32-row buckets load one float per row."""
    R, n = tensors[0].shape
    ok = R <= 8 and n % 4 == 0 and all(t.data_ptr() % 16 == 0
                                       for t in tensors)
    return 4 if ok else 1


_SM_COUNT = {}


def _grid(flat, vec):
    dev = flat.device.index if flat.device.index is not None \
        else torch.cuda.current_device()
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    groups = flat.shape[1] // vec
    return max(1, min(-(-groups // THREADS), BLOCKS_PER_SM * _SM_COUNT[dev]))


def workspace_blocks(flat):
    """Number of partial Grams the first launch of ``fused_round`` writes
    for this CUDA tensor (the leading dim of ``gram_coef``'s input)."""
    _check_flat(flat)
    return _grid(flat, _vec(flat))


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _raise_if(code, what):
    if code != 0:
        msg = _lib.pp_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _launch_partial_gram(flat):
    """partial-Gram kernel -> (nblk, R, R) workspace of block partials."""
    lib = build()
    R, n = flat.shape
    vec = _vec(flat)
    nblk = _grid(flat, vec)
    ws = torch.empty((nblk, R, R), dtype=torch.float32, device=flat.device)
    LAUNCHES["partial_gram"] += 1
    _raise_if(lib.pp_partial_gram(_ptr(flat), R, n, _ptr(ws), nblk, vec,
                                  _stream(flat)), "partial_gram")
    return ws


def _launch_gram_coef(ws, T=None, c0=None, c1=None, eps=1e-12):
    """Fixed-order sum of the partials into G; with T also r and coef."""
    lib = build()
    nblk, R, _ = ws.shape
    G = torch.empty((R, R), dtype=torch.float32, device=ws.device)
    r = torch.empty((R,), dtype=torch.float32, device=ws.device)
    coef = torch.empty((R,), dtype=torch.float32, device=ws.device)
    null = ctypes.c_void_p(None)
    LAUNCHES["gram_coef"] += 1
    _raise_if(lib.pp_gram_coef(
        _ptr(ws), nblk, R, null if T is None else _ptr(T),
        null if c0 is None else _ptr(c0), null if c1 is None else _ptr(c1),
        float(eps), _ptr(G), _ptr(r), _ptr(coef), _stream(ws)), "gram_coef")
    return G, r, coef


def _launch_mix(flat, T, coef, out):
    lib = build()
    R, n = flat.shape
    vec = _vec(flat, out)
    nblk = _grid(flat, vec)
    LAUNCHES["mix_shard"] += 1
    _raise_if(lib.pp_mix(_ptr(flat), R, n, _ptr(T), _ptr(coef), _ptr(out),
                         nblk, vec, _stream(flat)), "mix_shard")
    return out


# ---------------------------------------------------------------------------
# public wrappers (the reference's signatures, minus the TPU block knobs)
# ---------------------------------------------------------------------------

def fused_round(flat, T, c0, c1, eps=1e-12, out=None):
    """One consensus stage over the flat (R, n) worker matrix.

    Per row i: ``r_i = ||x_i - T_i x||``, ``coef_i = c0_i + c1_i /
    max(r_i, eps)``, ``out_i = T_i x + (1 - coef_i)(x_i - T_i x)``.
    ``T`` must be row-stochastic. ``out`` may be ``flat`` (in place).
    Returns ``(out, r, G)``; G is the block-centered Gram, so only its
    zero-sum quadratic forms mean anything.
    """
    _check_flat(flat)
    R = flat.shape[0]
    T = _small(T, (R, R), flat)
    c0 = _small(c0, (R,), flat)
    c1 = _small(c1, (R,), flat)
    out = _check_out(out, flat)
    if flat.device.type == "cpu":
        return fused_round_plain(flat, T, c0, c1, eps, out=out)
    LAUNCHES["fused_round"] += 1
    with torch.cuda.device(flat.device):
        ws = _launch_partial_gram(flat)
        G, r, coef = _launch_gram_coef(ws, T, c0, c1, eps)
        _launch_mix(flat, T, coef, out)
    return out, r, G


def partial_gram(flat):
    """Block-centered Gram of a (R, n_local) column shard; the partial
    Grams of disjoint shards add up to a Gram with the same zero-sum
    forms as the full-width one."""
    _check_flat(flat)
    if flat.device.type == "cpu":
        return partial_gram_plain(flat)
    with torch.cuda.device(flat.device):
        G, _, _ = _launch_gram_coef(_launch_partial_gram(flat))
    return G


def gram_coef(ws, T, c0, c1, eps=1e-12):
    """The middle launch of ``fused_round`` on its own: sum a (nblk, R, R)
    stack of partial Grams in a fixed order into G, then ``r`` and
    ``coef`` as in ``fused_round``. Returns ``(G, r, coef)``."""
    if not isinstance(ws, torch.Tensor) or ws.dim() != 3 \
            or ws.shape[1] != ws.shape[2] or ws.dtype != torch.float32:
        raise ValueError("ws must be a float32 (nblk, R, R) tensor")
    R = ws.shape[-1]
    _check_flat(ws[0])
    T = _small(T, (R, R), ws)
    c0 = _small(c0, (R,), ws)
    c1 = _small(c1, (R,), ws)
    if ws.device.type == "cpu":
        G = ws.sum(0)
        return (G, *gram_coef_plain(G, T, c0, c1, eps))
    with torch.cuda.device(ws.device):
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
    with torch.cuda.device(flat.device):
        return _launch_mix(flat, T, coef, out)

"""Hopper kernel for the Mamba2 SSD intra-chunk computation, and its
wrapper.

Replaces ``src/repro/kernels/mamba_scan/mamba_scan.py::ssd_chunks`` (body
``_kernel``): per (batch, head, chunk) the causal intra-chunk output
``y = (C B^T o exp(segsum a)) x`` and the chunk state
``x^T (B o exp(la_L - la))``, in fp32. ``csrc/mamba_scan.cu`` says how the
design differs from the TPU kernel (the products on the tensor cores in
error-compensated TF32, one block per chunk and group of heads,
G = C B^T formed once per group) and what bounds it (bytes).
``geometry(Bt, S, H, L)`` sizes the group of heads from the grid; the C
entry refuses any other geometry.

Two entry points share one launch:

* ``ssd_chunks(x, B_, C_, a_log)`` takes the reference's chunked layout;
* ``ssd_chunks_seq(xh, B_, C_, a_log, chunk)`` takes the model's layout
  ``(Bt, S, H, P)`` / ``(Bt, S, N)`` / ``(Bt, S, H)`` with any S: the kernel
  reads it through strides and masks the ragged last chunk, so nothing is
  padded or copied, and writes y in the model's layout.

The wrappers check their inputs before they dispatch, on either device.
For tensors on the CPU they run the plain version from ``ref.py``; for
CUDA tensors they launch the kernel or raise: there is no fallback. The
shared library is built from ``csrc/mamba_scan.cu`` at first CUDA use
(``build()``, through ``kernels/_build.py``), never at import.
``LAUNCHES["ssd_chunks"]`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan.ref import (
    ssd_chunks_plain, ssd_chunks_seq_plain,
)

# the kernel's tiles: L in 8-row tiles, P in m16 tiles, N in n8 tiles
MAX_L, MAX_P, MAX_N = 128, 64, 64
L_STEP, P_STEP, N_STEP = 8, 16, 8
MAX_HEADS = 32          # heads that share one G = C B^T, at most
THREADS = 256           # 8 warps a block, one block an SM
NUM_SMS = 132           # H100 SXM
SMEM_MAX = 232_448      # shared memory one block may use on Hopper
# a block's prologue (staging C, B and the sums of a, forming G) in heads'
# products: 33,500 cycles against about 11,300 a head at the serving shape
# (tools/ssd_phases.py on an H100)
G_COST = 3.0

LAUNCHES = {"ssd_chunks": 0}


@dataclass(frozen=True)
class Geometry:
    """The launch of ``Bt`` sequences of ``nc`` chunks over ``H`` heads:
    one block of ``threads`` per (chunk, group of ``heads_per_block``
    heads, sequence), ``grid = (nc, groups, Bt)``, each with
    ``smem_bytes`` of shared memory."""
    heads_per_block: int
    groups: int
    grid: tuple
    blocks: int
    threads: int
    smem_bytes: int

    def c_args(self):
        """The ints the C entry checks against its instance."""
        return (self.heads_per_block, self.threads, self.smem_bytes)


def smem_bytes(L, P, N, heads_per_block):
    """Shared bytes of one block (``csrc/mamba_scan.cu`` ``Layout``): x^T
    of two heads split into hi and lo (the first buffer holds C before the
    head loop), G's causal 8 x 8 blocks, B, and la and rem of each head
    (a row of heads per step, padded to an odd count)."""
    L16 = -(-L // 16) * 16
    nT = L // 8
    words = (4 * max(L * P, L16 * N) + nT * (nT + 1) // 2 * 64 + L * N
             + 2 * L * (heads_per_block | 1))
    return 4 * words


@functools.lru_cache(maxsize=256)
def geometry(Bt, S, H, L, P=MAX_P, N=MAX_N):
    """The kernel's launch geometry for ``Bt`` sequences of ``S`` tokens
    in chunks of ``L``, ``H`` heads of dim ``P`` and state ``N``. One block
    per SM runs at a time, so a launch takes ``ceil(blocks / NUM_SMS)``
    waves of ``heads_per_block`` heads' products plus one G each. The
    group is the size that makes that least, among those whose grid fills
    the card's SMs where the shape has that many (chunk, head) pairs;
    ties go to the larger group."""
    if min(Bt, S, H, L) < 1:
        raise ValueError(f"no geometry for Bt = {Bt}, S = {S}, H = {H}, "
                         f"L = {L}")
    nc = -(-S // L)
    need = min(NUM_SMS, Bt * nc * H)
    best = None
    for hpb in range(min(H, MAX_HEADS), 0, -1):
        groups = -(-H // hpb)
        if -(-H // groups) != hpb:      # the same groups with fewer heads
            continue
        blocks = Bt * nc * groups
        if blocks < need:
            continue
        cost = math.ceil(blocks / NUM_SMS) * (hpb + G_COST)
        if best is None or cost < best[0]:
            best = (cost, hpb, groups, blocks)
    _, hpb, groups, blocks = best
    return Geometry(heads_per_block=hpb, groups=groups, grid=(nc, groups, Bt),
                    blocks=blocks, threads=THREADS,
                    smem_bytes=smem_bytes(L, P, N, hpb))


def _bind(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_chunks_fwd.argtypes = [
        vp, vp, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_longlong),
        i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.ssd_chunks_fwd.restype = i32
    lib.ssd_error_string.argtypes = [i32]
    lib.ssd_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.ssd_error_string


SOURCE = _build.Source("mamba_scan", Path(__file__).resolve().parent
                       / "csrc" / "mamba_scan.cu", _bind)


def reset_launches():
    LAUNCHES["ssd_chunks"] = 0


def build():
    """Compile ``csrc/mamba_scan.cu`` (once per source hash) and load it.
    Returns the ``ctypes.CDLL``."""
    return _build.build(SOURCE)[0]


def _check(x, B_, C_, a_log, xdim):
    ts = (x, B_, C_, a_log)
    dims = (xdim, xdim - 1, xdim - 1, xdim - 1)
    if not all(isinstance(t, torch.Tensor) and t.dim() == d
               for t, d in zip(ts, dims)):
        raise ValueError(f"x must be {xdim}-D and B_, C_, a_log "
                         f"{xdim - 1}-D tensors")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("the kernel takes float32 x, B_, C_ and a_log")
    if len({t.device for t in ts}) != 1:
        raise ValueError("x, B_, C_, a_log lie on different devices")
    if any(t.stride(-1) != 1 for t in (x, B_, C_)):
        raise ValueError("the last axis of x, B_ and C_ must be contiguous "
                         "(stride 1)")
    # the kernel reads x and C_ in pairs of floats (8-byte loads); a meta
    # tensor (no memory) is placed by its storage offset
    for t in (x, C_):
        start = (t.storage_offset() * 4 if t.device.type == "meta"
                 else t.data_ptr())
        if start % 8 or any(st % 2 for st in t.stride()[:-1]):
            raise ValueError("x and C_ must start on an 8-byte boundary "
                             "with even strides")


def _check_dims(x, L, P, N):
    if not (L_STEP <= L <= MAX_L and L % L_STEP == 0 and P_STEP <= P <= MAX_P
            and P % P_STEP == 0 and N_STEP <= N <= MAX_N
            and N % N_STEP == 0):
        raise ValueError(f"chunk {L}, head dim {P}, state {N}: the kernel "
                         f"takes L <= {MAX_L} in multiples of {L_STEP}, "
                         f"P <= {MAX_P} in multiples of {P_STEP} and "
                         f"N <= {MAX_N} in multiples of {N_STEP}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _no_grad(*ts):
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("ssd_chunks has no backward kernel: call it "
                           "under torch.no_grad()")


def _launch(x, sx, B_, sb, C_, sc, a_log, sa, y, sy, st, sst, dims,
            t_valid):
    """One launch; ``s*`` are the element strides the C entry takes.
    Tokens ``c * L + l >= t_valid`` read as zero and their rows of y are
    not written."""
    Bt, H, nc, L, P, N = dims
    geo = geometry(Bt, int(t_valid), H, L, P, N)
    lib = build()
    strides = (ctypes.c_longlong * 22)(*sx, *sb, *sc, *sa, *sy, *sst)
    with torch.cuda.device(x.device):
        LAUNCHES["ssd_chunks"] += 1
        _build.raise_if(lib, lib.ssd_chunks_fwd(
            _build.ptr(x), _build.ptr(B_), _build.ptr(C_), _build.ptr(a_log),
            _build.ptr(y), _build.ptr(st), strides, Bt, H, nc, L, P, N,
            int(t_valid), *geo.c_args(), _build.stream(x)), "ssd_chunks")
    return y, st


def ssd_chunks(x, B_, C_, a_log):
    """x: (B, H, nc, L, P); B_, C_: (B, nc, L, N); a_log: (B, H, nc, L).
    Returns (y (B, H, nc, L, P), states (B, H, nc, P, N)), fp32. Forward
    only."""
    _check(x, B_, C_, a_log, 5)
    Bt, H, nc, L, P = x.shape
    N = B_.shape[-1]
    if (B_.shape != (Bt, nc, L, N) or C_.shape != B_.shape
            or a_log.shape != (Bt, H, nc, L)):
        raise ValueError(f"shapes x {tuple(x.shape)}, B_ {tuple(B_.shape)}, "
                         f"C_ {tuple(C_.shape)}, a_log {tuple(a_log.shape)} "
                         "do not agree")
    _check_dims(x, L, P, N)
    if x.device.type == "cpu":
        return ssd_chunks_plain(x, B_, C_, a_log)
    _no_grad(x, B_, C_, a_log)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    st = torch.empty((Bt, H, nc, P, N), dtype=torch.float32, device=x.device)
    return _launch(x, x.stride()[:4], B_, B_.stride()[:3], C_,
                   C_.stride()[:3], a_log, a_log.stride(), y,
                   y.stride()[:4], st, st.stride()[:4],
                   (Bt, H, nc, L, P, N), nc * L)


def ssd_chunks_seq(xh, B_, C_, a_log, chunk):
    """The model's layout. xh: (Bt, S, H, P); B_, C_: (Bt, S, N) (rows may
    be strided, e.g. column slices of the conv output); a_log: (Bt, S, H).
    Returns (y_intra (Bt, S, H, P), states (Bt, nc, H, P, N)) for
    nc = ceil(S / chunk), fp32: ``ssd_chunks`` on the zero-padded chunked
    view, without the padding (the kernel reads tokens at or past S as
    zero)."""
    _check(xh, B_, C_, a_log, 4)
    Bt, S, H, P = xh.shape
    N = B_.shape[-1]
    if (B_.shape != (Bt, S, N) or C_.shape != B_.shape
            or a_log.shape != (Bt, S, H)):
        raise ValueError(f"shapes xh {tuple(xh.shape)}, B_ "
                         f"{tuple(B_.shape)}, C_ {tuple(C_.shape)}, a_log "
                         f"{tuple(a_log.shape)} do not agree")
    L = int(chunk)
    _check_dims(xh, L, P, N)
    nc = -(-S // L)
    if xh.device.type == "cpu":
        return ssd_chunks_seq_plain(xh, B_, C_, a_log, L)
    _no_grad(xh, B_, C_, a_log)
    y = torch.empty((Bt, S, H, P), dtype=torch.float32, device=xh.device)
    st = torch.empty((Bt, nc, H, P, N), dtype=torch.float32,
                     device=xh.device)

    def by_chunk(t, head=True):   # (b, [h,] c, l) strides of (Bt, S, ...)
        sb_, ss = t.stride()[:2]
        return (sb_, t.stride(2), L * ss, ss) if head else (sb_, L * ss, ss)
    return _launch(xh, by_chunk(xh), B_, by_chunk(B_, False), C_,
                   by_chunk(C_, False), a_log, by_chunk(a_log), y,
                   by_chunk(y), st,
                   (st.stride(0), st.stride(2), st.stride(1), st.stride(3)),
                   (Bt, H, nc, L, P, N), S)

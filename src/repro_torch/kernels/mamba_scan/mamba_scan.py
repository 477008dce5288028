"""Hopper kernel for the Mamba2 SSD intra-chunk computation, and its
wrapper.

Replaces ``src/repro/kernels/mamba_scan/mamba_scan.py::ssd_chunks`` (body
``_kernel``): per (batch, head, chunk) the causal intra-chunk output
``y = (C B^T o exp(segsum a)) x`` and the chunk state
``x^T (B o exp(la_L - la))``, in fp32. ``csrc/mamba_scan.cu`` says how the
design differs from the TPU kernel (one block per chunk and group of
heads, G = C B^T formed once per group) and what bounds it (operations).

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
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan.ref import (
    ssd_chunks_plain, ssd_chunks_seq_plain,
)

MAX_L, MAX_P, MAX_N = 128, 64, 64     # the kernel's register micro-tiles
HEADS_PER_BLOCK = 16                  # heads that share one G = C B^T

LAUNCHES = {"ssd_chunks": 0}


def _bind(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_chunks_fwd.argtypes = [
        vp, vp, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_longlong),
        i32, i32, i32, i32, i32, i32, i32, i32, vp]
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


def _check_dims(x, L, P, N):
    if not (8 <= L <= MAX_L and L % 8 == 0 and 4 <= P <= MAX_P
            and P % 4 == 0 and 4 <= N <= MAX_N and N % 4 == 0):
        raise ValueError(f"chunk {L}, head dim {P}, state {N}: the kernel "
                         f"takes L <= {MAX_L} in multiples of 8 and "
                         f"P <= {MAX_P}, N <= {MAX_N} in multiples of 4")
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
    lib = build()
    Bt, H, nc, L, P, N = dims
    strides = (ctypes.c_longlong * 22)(*sx, *sb, *sc, *sa, *sy, *sst)
    with torch.cuda.device(x.device):
        LAUNCHES["ssd_chunks"] += 1
        _build.raise_if(lib, lib.ssd_chunks_fwd(
            _build.ptr(x), _build.ptr(B_), _build.ptr(C_), _build.ptr(a_log),
            _build.ptr(y), _build.ptr(st), strides, Bt, H, nc, L, P, N,
            int(t_valid), HEADS_PER_BLOCK, _build.stream(x)), "ssd_chunks")
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

"""Hopper kernels for sliding-window flash attention (forward), and their
wrapper.

Replaces ``src/repro/kernels/swa_attention/swa_attention.py::swa_attention``
(body ``_kernel``): GQA, causal mask, sliding-window band and tanh logit
softcap, online softmax in fp32. ``csrc/swa_attention.cu`` says how the
design differs from the TPU kernel: the kv loop runs over the band only,
nothing is padded, and keys past ``Skv`` never enter the softmax (the
Pallas wrapper's zero-padded keys do when they are not causally masked,
ROADMAP.md Queue 3). Bound: operations (compute), see the source.

The route goes by dtype: bfloat16 (the serving path) runs the tensor-core
kernel (``wgmma``, Q / K / V by TMA), float32 the CUDA-core kernel. TMA
reads a bf16 tensor through a descriptor that needs a 16-byte aligned base
and strides of whole 16-byte units, so a bf16 input that is not on the CPU
must have both, or the wrapper raises (the model's views from ``qkv_proj``
do). The wrapper checks its inputs before it dispatches, on either device.
For tensors on the CPU it runs the plain version from ``ref.py``; for CUDA
tensors it launches the kernel or raises: there is no fallback; on the
``meta`` device (launch analysis) it launches nothing, returns an empty
output and records the call at its ``cost()`` with the active
``launch.census.Census``. The shared
library is built from ``csrc/swa_attention.cu`` at first CUDA use
(``build()``, through ``kernels/_build.py``), never at import.
``LAUNCHES["swa_attention"]`` counts kernel launches of either route.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.swa_attention.ref import swa_attention_plain
from repro_torch.launch.census import record_kernel

HEAD_DIMS = (64, 112, 128, 256)   # the kernel's template instances
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# TMA's rules for a bf16 tensor map: the base and each stride a whole
# number of 16-byte units
_TMA_ALIGN = 16

LAUNCHES = {"swa_attention": 0}


def _bind(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.swa_attention_fwd.argtypes = [
        vp, vp, vp, vp, ctypes.POINTER(ctypes.c_longlong),
        i32, i32, i32, i32, i32, i32, i32, i32, i32,
        ctypes.c_float, ctypes.c_float, vp]
    lib.swa_attention_fwd.restype = i32
    lib.swa_error_string.argtypes = [i32]
    lib.swa_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.swa_error_string


SOURCE = _build.Source("swa_attention", Path(__file__).resolve().parent
                       / "csrc" / "swa_attention.cu", _bind)


def reset_launches():
    LAUNCHES["swa_attention"] = 0


@functools.lru_cache(maxsize=256)
def in_band_pairs(Sq, Skv, causal, window):
    """(q, k) pairs the mask keeps, counted for these shapes."""
    total = 0
    for q in range(Sq):
        lo = max(q - window + 1, 0) if window > 0 else 0
        hi = min(q, Skv - 1) if causal else Skv - 1
        total += max(hi - lo + 1, 0)
    return total


def cost(B, H, Hkv, Sq, Skv, hd, *, window=0, causal=True, esize=2):
    """The work of one call: ``{"flops", "bytes"}``, 4 hd FLOPs per
    in-band (q, k) pair per (b, h), and q, k, v read once and the output
    written once (``esize`` bytes an element). ``chip_smoke.py``'s bound
    divides them by the peak of the inputs' type and the memory rate."""
    flops = in_band_pairs(Sq, Skv, causal, window) * 4 * hd * B * H
    nbytes = esize * hd * (2 * B * H * Sq + 2 * B * Hkv * Skv)
    return {"flops": flops, "bytes": nbytes}


def build():
    """Compile ``csrc/swa_attention.cu`` (once per source hash) and load
    it. Returns the ``ctypes.CDLL``."""
    return _build.build(SOURCE)[0]


def _check_tma(ts):
    """A bf16 tensor off the CPU goes to the TMA kernel: raise on a base or
    a (B, H, S) stride TMA cannot describe."""
    for name, t in zip("qkv", ts):
        if t.data_ptr() % _TMA_ALIGN:
            raise ValueError(f"{name}: a bf16 base address that is not "
                             f"{_TMA_ALIGN}-byte aligned (the kernel reads "
                             "it by TMA)")
        for axis, st in enumerate(t.stride()[:3]):
            if (2 * st) % _TMA_ALIGN:
                raise ValueError(
                    f"{name}: stride {st} of axis {axis} is not a multiple "
                    f"of {_TMA_ALIGN // 2} elements (the kernel reads bf16 "
                    "by TMA)")


def _check(q, k, v, window, cap):
    ts = (q, k, v)
    if not all(isinstance(t, torch.Tensor) and t.dim() == 4 for t in ts):
        raise ValueError("q, k, v must be 4-D (B, H, S, hd) tensors")
    if len({t.dtype for t in ts}) != 1:
        raise TypeError(f"mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype}: the kernel takes float32 and "
                        "bfloat16")
    if len({t.device for t in ts}) != 1:
        raise ValueError("q, k, v lie on different devices")
    B, H, Sq, hd = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    Bk, Hkv, Skv, hdk = k.shape
    if Bk != B or hdk != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head_dim")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the kernel takes {HEAD_DIMS}")
    if Sq < 1 or Skv < 1:
        raise ValueError("empty query or key sequence")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("the head_dim axis must be contiguous (stride 1)")
    if q.dtype == torch.bfloat16 and q.device.type != "cpu":
        _check_tma(ts)
    if int(window) < 0 or float(cap) < 0:
        raise ValueError(f"window {window} and cap {cap} must be >= 0")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")


def swa_attention(q, k, v, *, causal=True, window=0, cap=0.0):
    """q: (B, H, Sq, hd); k, v: (B, Hkv, Skv, hd) -> (B, H, Sq, hd) in q's
    dtype. Any strides with a contiguous head_dim axis; the output takes
    q's strides. Forward only: raises if a gradient is asked for."""
    _check(q, k, v, window, cap)
    if q.device.type == "cpu":
        return swa_attention_plain(q, k, v, causal=causal, window=window,
                                   cap=cap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("swa_attention has no backward kernel: call it "
                           "under torch.no_grad()")
    B, H, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if q.device.type == "meta":
        record_kernel("swa_attention", cost(
            B, H, Hkv, Sq, Skv, hd, window=int(window), causal=bool(causal),
            esize=q.element_size()), (q, k, v), (out,))
        return out
    lib = build()
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        LAUNCHES["swa_attention"] += 1
        _build.raise_if(lib, lib.swa_attention_fwd(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            strides, B, H, Hkv, Sq, Skv, hd, _DTYPES[q.dtype], int(causal),
            int(window), float(cap), float(hd ** -0.5), _build.stream(q)),
            "swa_attention")
    return out

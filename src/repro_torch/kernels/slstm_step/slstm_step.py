"""Hopper kernel for the sLSTM recurrence, and its wrapper.

Replaces ``src/repro/kernels/slstm_step/slstm_step.py::slstm_steps`` (body
``_kernel``): T steps of ``g = g_in[t] + h R`` with exponential gates and
the m stabiliser, the state carried, in fp32. ``csrc/slstm_step.cu`` says
how the design differs from the TPU kernel (one block per (batch, head)
runs every step of one launch, so nothing is padded or masked; R streams
from L2) and what bounds it.

``slstm_steps(g_in, R, state, out_state=None)`` takes g_in in the model's
layout read through its strides (the last axis contiguous), R (H, P, 4P)
and the state (c, n, h, m) contiguous (B, H, P), and returns
``(h_out (B, T, H, P), final state)``. The final state goes into
``out_state`` when one is given (it may be ``state`` itself: an in-place
update), else into new tensors.

The wrapper checks its inputs before it dispatches, on either device. For
tensors on the CPU it runs the plain version from ``ref.py``; for CUDA
tensors it launches the kernel or raises: there is no fallback. The shared
library is built from ``csrc/slstm_step.cu`` at first CUDA use
(``build()``, through ``kernels/_build.py``), never at import.
``LAUNCHES["slstm_steps"]`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slstm_step.ref import slstm_steps_ref

HEAD_DIMS = (8, 16, 32, 128, 512)   # the kernel's template instances

LAUNCHES = {"slstm_steps": 0}


def _bind(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.slstm_steps_fwd.argtypes = [vp] * 11 + [
        ctypes.POINTER(ctypes.c_longlong), i32, i32, i32, i32, vp]
    lib.slstm_steps_fwd.restype = i32
    lib.slstm_error_string.argtypes = [i32]
    lib.slstm_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.slstm_error_string


SOURCE = _build.Source("slstm_step", Path(__file__).resolve().parent
                       / "csrc" / "slstm_step.cu", _bind)


def reset_launches():
    LAUNCHES["slstm_steps"] = 0


def build():
    """Compile ``csrc/slstm_step.cu`` (once per source hash) and load it.
    Returns the ``ctypes.CDLL``."""
    return _build.build(SOURCE)[0]


def _check(g_in, R, state, out_state):
    if not (isinstance(g_in, torch.Tensor) and g_in.dim() == 4
            and isinstance(R, torch.Tensor) and R.dim() == 3):
        raise ValueError("g_in must be a 4-D (B, T, H, 4P) and R a 3-D "
                         "(H, P, 4P) tensor")
    states = [("state", state)] + ([] if out_state is None
                                   else [("out_state", out_state)])
    for what, st in states:
        if not (isinstance(st, (tuple, list)) and len(st) == 4 and all(
                isinstance(t, torch.Tensor) for t in st)):
            raise ValueError(f"{what} must be four tensors (c, n, h, m)")
    ts = [g_in, R] + [t for _, st in states for t in st]
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("the kernel takes float32 g_in, R and state")
    if len({t.device for t in ts}) != 1:
        raise ValueError("g_in, R and the state lie on different devices")
    B, T, H, P4 = g_in.shape
    P = P4 // 4
    if P4 % 4 or T < 1 or tuple(R.shape) != (H, P, P4) or any(
            tuple(t.shape) != (B, H, P) for t in ts[2:]):
        raise ValueError(f"shapes g_in {tuple(g_in.shape)}, R "
                         f"{tuple(R.shape)}, state "
                         f"{[tuple(t.shape) for t in ts[2:]]} do not agree "
                         "(g_in (B, T >= 1, H, 4P), R (H, P, 4P), state "
                         "(B, H, P))")
    if P not in HEAD_DIMS:
        raise ValueError(f"head dim P = {P}: the kernel takes P in "
                         f"{HEAD_DIMS}")
    if g_in.stride(-1) != 1 or not all(t.is_contiguous() for t in ts[1:]):
        raise ValueError("g_in's last axis, R and the state must be "
                         "contiguous")
    if g_in.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {g_in.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("slstm_steps has no backward kernel: call it "
                           "under torch.no_grad()")


def slstm_steps(g_in, R, state, out_state=None):
    """g_in: (B, T, H, 4P); R: (H, P, 4P); state: (c, n, h, m) each
    (B, H, P); fp32. Returns (h_out (B, T, H, P), final state), the final
    state in ``out_state`` when given. Forward only."""
    _check(g_in, R, state, out_state)
    if g_in.device.type == "cpu":
        out, final = slstm_steps_ref(g_in, R, state)
        if out_state is None:
            return out, final
        for dst, src in zip(out_state, final):
            dst.copy_(src)
        return out, tuple(out_state)
    B, T, H, P4 = g_in.shape
    P = P4 // 4
    out = torch.empty((B, T, H, P), dtype=torch.float32, device=g_in.device)
    final = (tuple(out_state) if out_state is not None else
             tuple(torch.empty_like(t) for t in state))
    lib = build()
    strides = (ctypes.c_longlong * 6)(*g_in.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(g_in.device):
        LAUNCHES["slstm_steps"] += 1
        _build.raise_if(lib, lib.slstm_steps_fwd(
            _build.ptr(g_in), _build.ptr(R), *map(_build.ptr, state),
            _build.ptr(out), *map(_build.ptr, final), strides, B, T, H, P,
            _build.stream(g_in)), "slstm_steps")
    return out, final

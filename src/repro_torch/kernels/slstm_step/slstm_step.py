"""Hopper kernel for the sLSTM recurrence, and its wrapper.

Replaces ``src/repro/kernels/slstm_step/slstm_step.py::slstm_steps`` (body
``_kernel``): T steps of ``g = g_in[t] + h R`` with exponential gates and
the m stabiliser, the state carried, in fp32. ``csrc/slstm_step.cu`` says
how the design differs from the TPU kernel (each head's R held on chip by
a thread-block cluster, each block owning a slice of the state, h sent
to every block of the cluster through distributed shared memory and
counted on each receiver's mbarrier; one launch runs every step, so
nothing is padded or masked) and what bounds it. ``geometry(P, B)``
states the launch geometry of each instance; the C entry refuses any
other.

``slstm_steps(g_in, R, state, out_state=None)`` takes g_in in the model's
layout read through its strides (the last axis contiguous), R (H, P, 4P)
and the state (c, n, h, m) contiguous (B, H, P), and returns
``(h_out (B, T, H, P), final state)``. The final state goes into
``out_state`` when one is given (it may be ``state`` itself: an in-place
update), else into new tensors.

The wrapper checks its inputs before it dispatches, on either device. For
tensors on the CPU it runs the plain version from ``ref.py``; for CUDA
tensors it launches the kernel or raises: there is no fallback; on the
``meta`` device (launch analysis) it launches nothing, returns empty
outputs and records the call at its ``cost()`` with the active
``launch.census.Census``. The shared
library is built from ``csrc/slstm_step.cu`` at first CUDA use
(``build()``, through ``kernels/_build.py``), never at import.
``LAUNCHES["slstm_steps"]`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slstm_step.ref import slstm_steps_ref
from repro_torch.launch.census import record_kernel

HEAD_DIMS = (8, 16, 32, 128, 512)   # the kernel's template instances

LAUNCHES = {"slstm_steps": 0}

G = 4                   # batch rows per cluster (a batch group)
SMEM_MAX = 232_448      # shared memory one block may use on Hopper
# P: (C blocks per cluster, rows of R held in registers)
_GEOMETRY = {8: (1, 0), 16: (1, 0), 32: (1, 0), 128: (4, 0), 512: (16, 128)}


@dataclass(frozen=True)
class Geometry:
    """The launch geometry of the kernel at head dim P and batch B: per
    head, a cluster of ``C`` blocks for each of ``groups`` batch groups of
    ``G`` rows. Block r owns state elements [r S, (r + 1) S) and R's 4S
    columns for them, one thread per column; R's rows k < ``rows_reg``
    live in registers, the other ``rows_smem`` in shared memory."""
    P: int
    C: int
    G: int
    S: int
    threads: int
    rows_reg: int
    rows_smem: int
    smem_bytes: int
    groups: int

    def batch_rows(self, B):
        """[(first row, rows)] of each batch group, in grid order."""
        return [(b0, min(self.G, B - b0)) for b0 in range(0, B, self.G)]

    def c_args(self):
        """The ints the C entry checks against its instance."""
        return (self.C, self.G, self.rows_reg, self.threads, self.smem_bytes)


@functools.lru_cache(maxsize=64)
def geometry(P, B):
    """The kernel's launch geometry for head dim P (one of ``HEAD_DIMS``)
    and B >= 1 batch rows."""
    if P not in _GEOMETRY or B < 1:
        raise ValueError(f"no geometry for P = {P}, B = {B}")
    C, rows_reg = _GEOMETRY[P]
    S = P // C
    # R's shared rows, h's two buffers, the columns' sums, two mbarriers
    smem = 4 * ((P - rows_reg) * 4 * S + 2 * G * P + G * 4 * S) + 16
    return Geometry(P=P, C=C, G=G, S=S, threads=4 * S, rows_reg=rows_reg,
                    rows_smem=P - rows_reg, smem_bytes=smem,
                    groups=-(-B // G))


def _bind(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.slstm_steps_fwd.argtypes = [vp] * 11 + [
        ctypes.POINTER(ctypes.c_longlong), i32, i32, i32, i32,
        ctypes.POINTER(ctypes.c_int), vp]
    lib.slstm_steps_fwd.restype = i32
    lib.slstm_max_active_clusters.argtypes = [i32,
                                              ctypes.POINTER(ctypes.c_int)]
    lib.slstm_max_active_clusters.restype = i32
    lib.slstm_exchange_probe.argtypes = [vp, i32, i32, i32, vp]
    lib.slstm_exchange_probe.restype = i32
    lib.slstm_error_string.argtypes = [i32]
    lib.slstm_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.slstm_error_string


SOURCE = _build.Source("slstm_step", Path(__file__).resolve().parent
                       / "csrc" / "slstm_step.cu", _bind)


def reset_launches():
    LAUNCHES["slstm_steps"] = 0


def cost(B, T, H, P):
    """The work of one call: ``{"flops", "bytes"}``, 2 B T H P 4P FLOP
    for h @ R, and g_in, R and the state read once and h and the final
    state written once. ``chip_smoke.py``'s bound divides them by the
    fp32 peak and the memory rate."""
    flops = 2 * B * T * H * P * 4 * P
    nbytes = 4 * (B * T * H * 4 * P + H * P * 4 * P + B * T * H * P
                  + 8 * B * H * P)
    return {"flops": flops, "bytes": nbytes}


def build():
    """Compile ``csrc/slstm_step.cu`` (once per source hash) and load it.
    Returns the ``ctypes.CDLL``."""
    return _build.build(SOURCE)[0]


def max_active_clusters(P, device=None):
    """``cudaOccupancyMaxActiveClusters`` of the P instance on the current
    (or given) card: how many of its clusters run at once."""
    lib = build()
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.raise_if(lib, lib.slstm_max_active_clusters(
            P, ctypes.byref(n)), "slstm_max_active_clusters")
    return n.value


EXCHANGES = ("cluster barrier", "st.shared::cluster + cluster barrier",
             "st.async + mbarrier")


def exchange_probe(H, T, mode, device=None):
    """Launch the P = 512 geometry's per-step synchronisation alone (no
    arithmetic), T steps over H heads, on the current stream: ``mode``
    indexes ``EXCHANGES`` (2 is the kernel's). For timing what a step pays
    above its arithmetic; not counted in ``LAUNCHES``."""
    lib = build()
    # each of a head's 16 blocks writes its 128 gate threads' last h
    sink = torch.empty(H * 16 * 128, dtype=torch.float32,
                       device=device or "cuda")
    with torch.cuda.device(sink.device):
        _build.raise_if(lib, lib.slstm_exchange_probe(
            _build.ptr(sink), H, T, mode, _build.stream(sink)),
            "slstm_exchange_probe")
    return sink


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
    if g_in.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {g_in.device}")
    if g_in.device.type == "cuda" and R.data_ptr() % 16:
        raise ValueError("R must start on a 16-byte boundary (the kernel "
                         "copies it in 16-byte pieces)")
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
    if g_in.device.type == "meta":
        record_kernel("slstm_steps", cost(B, T, H, P), (g_in, R, *state),
                      (out, *final))
        return out, final
    geo = (ctypes.c_int * 5)(*geometry(P, B).c_args())
    lib = build()
    strides = (ctypes.c_longlong * 6)(*g_in.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(g_in.device):
        LAUNCHES["slstm_steps"] += 1
        _build.raise_if(lib, lib.slstm_steps_fwd(
            _build.ptr(g_in), _build.ptr(R), *map(_build.ptr, state),
            _build.ptr(out), *map(_build.ptr, final), strides, B, T, H, P,
            geo, _build.stream(g_in)), "slstm_steps")
    return out, final

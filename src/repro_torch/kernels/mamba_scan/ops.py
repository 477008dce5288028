"""The full chunked SSD scan over the ssd_chunks kernel (counterpart of
``repro/kernels/mamba_scan/ops.py::ssd_scan``).

``chunked_scan`` is the one scan: an intra-chunk function gives the
causal intra-chunk output and the chunk states, and the inter-chunk state
recursion is torch glue, as the reference leaves it in jnp. ``ssd_scan``
passes the kernel's ``ssd_chunks_seq`` (the kernel on a card, its plain
version on the CPU); ``models/ssm.py::_ssd_chunked``, the differentiable
route, passes the plain ``ssd_chunks_seq_plain``. Unlike the reference's
``ssd_scan`` this one takes the model's layout (as ``_ssd_chunked`` in
``repro/models/ssm.py`` does) and the carried-in state ``h0`` that chunked
prefill needs. The host loop over chunks carries only the (Bt, H, P, N)
state update; the inter-chunk output of every chunk is formed after the
loop in one batched product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan.mamba_scan import ssd_chunks_seq


def chunked_scan(intra, xh, B_, C_, a_log, chunk, h0=None):
    """xh: (Bt, S, H, P) inputs already scaled by dt; B_, C_: (Bt, S, N);
    a_log: (Bt, S, H) per-step log decay (<= 0); ``h0`` (Bt, H, P, N) the
    carried-in state (default zero). ``intra(xh, B_, C_, a_log, chunk)``
    returns (y_intra (Bt, S, H, P), states (Bt, nc, H, P, N)). Returns y
    (Bt, S, H, P) and the final state (Bt, H, P, N), fp32."""
    Bt, S, H, P = xh.shape
    N = B_.shape[-1]
    y, states = intra(xh, B_, C_, a_log, chunk)
    nc = states.shape[1]
    pad = nc * chunk - S
    # a_log and C_ are small beside xh: padding them with zeros is exact
    a_pad = F.pad(a_log, (0, 0, 0, pad))
    la = torch.cumsum(a_pad.reshape(Bt, nc, chunk, H), dim=2)
    chunk_decay = torch.exp(la[:, :, -1])                # (Bt, nc, H)
    h = (torch.zeros((Bt, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.to(torch.float32))
    entering = torch.empty_like(states)                  # state before chunk c
    for c in range(nc):
        entering[:, c] = h
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    # y[t] += exp(la_t) C_t . h_entering, for every chunk at once
    C_pad = F.pad(C_, (0, 0, 0, pad))
    y_inter = torch.matmul(C_pad.reshape(Bt, nc, chunk, N),
                           entering.reshape(Bt, nc, H * P, N).transpose(2, 3))
    y_inter = y_inter.reshape(Bt, nc * chunk, H, P)[:, :S]
    decay = torch.exp(la).reshape(Bt, nc * chunk, H)[:, :S, :, None]
    return torch.addcmul(y, y_inter, decay), h


def ssd_scan(xh, B_, C_, a_log, chunk, h0=None):
    """``chunked_scan`` with the kernel's intra-chunk part: the serving
    route (no gradient)."""
    return chunked_scan(ssd_chunks_seq, xh, B_, C_, a_log, chunk, h0)

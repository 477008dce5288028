"""Plain PyTorch version of the Mamba2 SSD intra-chunk kernel.

Counterpart of ``repro/kernels/mamba_scan/ref.py`` (``chunk_ref``,
``ssd_chunks_ref``), in fp32 and batched with einsum where the reference
vmaps. Per (batch, head, chunk) with chunk length L:

  la          = cumsum(a_log) within the chunk                  (L,)
  y_intra[t]  = sum_{s<=t} exp(la_t - la_s) * (C_t . B_s) * x_s (L, P)
  state       = sum_s exp(la_L - la_s) * B_s (x) x_s            (P, N)

Pairs with s > t are masked to -1e30 BEFORE exp (there la_t - la_s > 0
and exp would overflow, and its gradient with it). The CPU tests hold
these against the reference; ``chip_smoke.py`` holds the CUDA kernel
against them on the card. ``ssd_chunks_seq_plain`` is also the
intra-chunk part of the model's differentiable route
(``models/ssm.py::_ssd_chunked``).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def chunk_ref(x, B_, C_, a_log):
    """x: (L, P); B_, C_: (L, N); a_log: (L,) -> (y (L, P), state (P, N))."""
    y, st = ssd_chunks_plain(x[None, None, None], B_[None, None],
                             C_[None, None], a_log[None, None, None])
    return y[0, 0, 0], st[0, 0, 0]


def ssd_chunks_plain(x, B_, C_, a_log):
    """x: (B, H, nc, L, P); B_, C_: (B, nc, L, N); a_log: (B, H, nc, L).
    Returns (y like x, states (B, H, nc, P, N)), fp32."""
    x, B_, C_, a_log = (t.to(torch.float32) for t in (x, B_, C_, a_log))
    L = x.shape[3]
    la = torch.cumsum(a_log, dim=-1)                     # (B, H, nc, L)
    seg = la[..., :, None] - la[..., None, :]            # (B, H, nc, t, s)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    decay = torch.exp(torch.where(causal, seg, NEG_INF))
    G = torch.einsum("bctn,bcsn->bcts", C_, B_)          # (B, nc, t, s)
    y = torch.einsum("bhcts,bhcsp->bhctp", G[:, None] * decay, x)
    rem = torch.exp(la[..., -1:] - la)                   # (B, H, nc, L)
    st = torch.einsum("bhcsp,bcsn->bhcpn", x * rem[..., None], B_)
    return y, st


def ssd_chunks_seq_plain(xh, B_, C_, a_log, chunk):
    """The model's layout: xh (Bt, S, H, P); B_, C_ (Bt, S, N); a_log
    (Bt, S, H). Pads S to whole chunks with zeros (as the reference does),
    runs ``ssd_chunks_plain`` and returns (y_intra (Bt, S, H, P), states
    (Bt, nc, H, P, N))."""
    Bt, S, H, P = xh.shape
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def chunked(t, n_tail):
        t = torch.nn.functional.pad(t, (0, 0) * n_tail + (0, pad))
        return t.reshape((Bt, nc, chunk) + t.shape[2:])
    y, st = ssd_chunks_plain(
        chunked(xh, 2).permute(0, 3, 1, 2, 4), chunked(B_, 1),
        chunked(C_, 1), chunked(a_log, 1).permute(0, 3, 1, 2))
    y = y.permute(0, 2, 3, 1, 4).reshape(Bt, nc * chunk, H, P)[:, :S]
    return y, st.transpose(1, 2)

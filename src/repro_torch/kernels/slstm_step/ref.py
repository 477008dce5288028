"""Plain PyTorch version of the sLSTM recurrence kernel.

Counterpart of ``repro/kernels/slstm_step/ref.py::slstm_steps_ref``, in
fp32. Inputs: pre-computed input gate projections g_in (B, T, H, 4P),
block-diagonal recurrent weights R (H, P, 4P), state (c, n, h, m) each
(B, H, P). Per step (exponential gating with the max stabiliser):

    g  = g_in[t] + h @ R            -> split z, i, f, o  (P each)
    m' = max(f + m, i);  ie = exp(i - m');  fe = exp(f + m - m')
    c  = fe c + ie tanh(z);  n = fe n + ie
    h  = sigmoid(o) * c / max(n, 1e-6)

It is also the model's differentiable route (``models/xlstm.py::
slstm_forward`` with a gradient recorded): the loop is plain torch, which
autograd follows. The CPU tests hold it against the reference;
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch


def slstm_steps_ref(g_in, R, state):
    """g_in: (B, T, H, 4P); R: (H, P, 4P); state: (c, n, h, m) (B, H, P).
    Returns (h_out (B, T, H, P), final state). Nothing is written in
    place."""
    P = g_in.shape[-1] // 4
    c, n, h, m = state
    hs = []
    for t in range(g_in.shape[1]):
        g = g_in[:, t] + torch.einsum("bhp,hpq->bhq", h, R)
        z_r, i_r, f_r, o_r = torch.split(g, P, dim=-1)
        m_new = torch.maximum(f_r + m, i_r)
        ie = torch.exp(i_r - m_new)
        fe = torch.exp(f_r + m - m_new)
        c = fe * c + ie * torch.tanh(z_r)
        n = fe * n + ie
        h = torch.sigmoid(o_r) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, h, m)

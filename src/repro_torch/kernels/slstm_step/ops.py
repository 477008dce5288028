"""The sLSTM scan over the slstm_steps kernel (counterpart of
``repro/kernels/slstm_step/ops.py::slstm_scan``).

``slstm_scan`` runs the kernel on a card and its plain version on the CPU
(the wrapper dispatches on the tensors' device). Unlike the reference it
pads nothing: the kernel runs exactly T steps, so no padded copy of g_in
and no ``t_valid`` mask are needed. The final state is written into the
caller's state tensors in place (on the card the kernel writes it there
directly). Forward only: the kernel has no backward, so the model's
differentiable route runs ``slstm_steps_ref``.
"""
from __future__ import annotations

from repro_torch.kernels.slstm_step.slstm_step import slstm_steps


def slstm_scan(g_in, R, state):
    """g_in: (B, T, H, 4P); R: (H, P, 4P); state: (c, n, h, m) (B, H, P),
    updated in place. Returns (h_out (B, T, H, P), state)."""
    return slstm_steps(g_in, R, state, out_state=state)

"""Plain PyTorch LSTM layer.

Port of the JAX package's ``ops/lstm.py::lstm_layer``: the input
projection ``x @ W_ih^T + b`` for all steps is hoisted out of the
recurrence, and gate order is i, f, g, o (torch's layout). The recurrence
is K1's plain version, so in f32 this is the JAX scan's function; in bf16
it keeps K1's rounding (f32 gates, the carry rounded to bf16 each step)
where the JAX scan computes its gates in bf16.
"""

from __future__ import annotations

from typing import Tuple

import torch

from code_intelligence_tpu_torch.ops.fused_lstm import (
    LSTMState,
    fused_lstm_forward_plain,
    project_time_major,
)

__all__ = ["LSTMState", "lstm_layer"]


def lstm_layer(x: torch.Tensor, state: LSTMState, w_ih: torch.Tensor,
               w_hh: torch.Tensor, bias: torch.Tensor
               ) -> Tuple[torch.Tensor, LSTMState]:
    """One LSTM layer over a window on any device: ``x (B, T, in)`` ->
    ``(out (B, T, H), (h_T, c_T))``. Autograd through this loop is the
    reference for the training path's K4 and K5; DropConnect is applied to
    ``w_hh`` by the caller (``AWDLSTMEncoder``), as for the fused layer."""
    x_proj = project_time_major(x, w_ih, bias)
    dtype = x_proj.dtype
    h0, c0 = state
    out, st = fused_lstm_forward_plain(x_proj, w_hh, h0.to(dtype),
                                       c0.to(dtype))
    return out.transpose(0, 1), st

"""QRNN layer with fo-pooling.

Port of the JAX package's ``ops/qrnn.py``. The recurrence

    h_t = f_t * h_{t-1} + (1 - f_t) * z_t

runs through the forget-mult kernels of ``ops/forget_mult.py`` (K6, K7
and K8); the gate projection is a plain ``torch.matmul`` outside them, as
the JAX package leaves it to XLA. The JAX package's default associative
scan computes the same function as K6 and has no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from code_intelligence_tpu_torch.ops.forget_mult import (
    forget_mult_forward_plain,
    forget_mult_fused,
    forget_mult_ragged,
    forget_mult_ragged_plain,
)
from code_intelligence_tpu_torch.ops.fused_lstm import project_time_major


def qrnn_layer(x: torch.Tensor, params: dict,
               h0: Optional[torch.Tensor] = None, window: int = 1,
               x_prev: Optional[torch.Tensor] = None,
               valid_lens: Optional[torch.Tensor] = None,
               plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One QRNN layer: ``x (B, T, in)`` -> ``(o * h (B, T, H), h_T (B, H))``.

    ``params``: ``w (3H, window * in)`` and ``b (3H,)``, gates in order z,
    f, o. With ``window=2`` each step sees ``[x_{t-1}, x_t]``; ``x_prev
    (B, in)`` is the previous window's last input (zeros when None). The
    gates come out time-major, so the recurrence reads ``(T, B, H)`` with
    no transpose.

    ``valid_lens (B,) int32`` (inference) runs K8, whose outputs past a
    row's length hold its frozen carry; otherwise the recurrence is
    ``forget_mult_fused`` (K6, and K7 in the backward). ``plain=True`` runs
    the plain loops on any device. ``h_T`` is the last stored output, in
    the compute dtype, as the JAX layer returns it."""
    if window == 2:
        first = (torch.zeros_like(x[:, :1]) if x_prev is None
                 else x_prev[:, None].to(x.dtype))
        x = torch.cat([torch.cat([first, x[:, :-1]], dim=1), x], dim=-1)
    elif window != 1:
        raise ValueError(f"window must be 1 or 2, got {window}")
    gates = project_time_major(x, params["w"], params["b"])  # (T, B, 3H)
    z, f, o = gates.chunk(3, dim=-1)
    z, f, o = torch.tanh(z), torch.sigmoid(f), torch.sigmoid(o)
    if h0 is None:
        h0 = z.new_zeros(z.shape[1:])
    h0 = h0.to(z.dtype).contiguous()
    if valid_lens is not None:
        ragged = forget_mult_ragged_plain if plain else forget_mult_ragged
        h = ragged(z, f, h0, valid_lens.to(torch.int32).contiguous())
    elif plain:
        h = forget_mult_forward_plain(z, f, h0)
    else:
        h = forget_mult_fused(z, f, h0)
    return (o * h).transpose(0, 1), h[-1]

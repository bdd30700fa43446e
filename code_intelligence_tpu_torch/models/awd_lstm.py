"""AWD-LSTM encoder, inference branch.

Port of the deterministic LSTM branch of the JAX package's
``models/awd_lstm.py::AWDLSTMEncoder``: embedding gather, then N stacked
LSTM layers, each an input projection plus the fused recurrence
(``ops/fused_lstm.py``, kernel K1 on CUDA). Dropout, DropConnect and the
sequence-parallel axis are training concerns and are not ported here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from code_intelligence_tpu_torch.ops.fused_lstm import lstm_layer_fused
from code_intelligence_tpu_torch.ops.lstm import LSTMState, lstm_layer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AWDLSTMConfig:
    """Reads every key of the JAX package's ``model_config.json``.

    ``lstm_use_pallas`` is accepted and ignored: the port has one kernel
    path on CUDA. The dropout rates are kept for the round trip and unused
    at inference.
    """

    vocab_size: int
    emb_sz: int = 800
    n_hid: int = 2500
    n_layers: int = 4
    pad_id: int = 1
    output_p: float = 0.1
    hidden_p: float = 0.15
    input_p: float = 0.25
    embed_p: float = 0.02
    weight_p: float = 0.2
    tie_weights: bool = True
    out_bias: bool = True
    qrnn: bool = False
    qrnn_use_pallas: bool = False
    lstm_use_pallas: bool = False
    seq_axis: Optional[str] = None
    dtype: str = "float32"
    precision: str = "f32"

    def __post_init__(self):
        if self.qrnn:
            raise NotImplementedError(
                "qrnn=True is not ported yet (ROADMAP.md queue 1 item 10, "
                "with kernels K6-K8)")
        if self.precision == "int8":
            raise NotImplementedError(
                "precision='int8' is not ported yet (ROADMAP.md queue 1 "
                "item 6, with kernel K3)")
        if self.precision != "f32":
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.dtype not in _DTYPES:
            raise ValueError(
                f"dtype {self.dtype!r} is not supported (one of "
                f"{sorted(_DTYPES)})")

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def layer_size(self, layer: int) -> int:
        """Hidden size per layer: n_hid except the last, which equals
        emb_sz so the decoder can tie with the embedding."""
        return self.emb_sz if layer == self.n_layers - 1 else self.n_hid

    def layer_in_dim(self, layer: int) -> int:
        return self.emb_sz if layer == 0 else self.n_hid


def init_lstm_states(config: AWDLSTMConfig, batch_size: int,
                     device="cpu") -> Tuple[LSTMState, ...]:
    """Zero ``(h, c)`` per layer, each ``(batch_size, H)`` in the compute
    dtype."""
    states = []
    for li in range(config.n_layers):
        h = torch.zeros((batch_size, config.layer_size(li)),
                        dtype=config.torch_dtype, device=device)
        states.append((h, torch.zeros_like(h)))
    return tuple(states)


def random_encoder_arrays(config: AWDLSTMConfig, seed: int = 0) -> dict:
    """Random f32 encoder weights in the export's flat layout, from a numpy
    seed, with the JAX package's init ranges: U(-0.1, 0.1) for the
    embedding and U(-1/sqrt(H), 1/sqrt(H)) for each LSTM tensor."""
    rng = np.random.default_rng(seed)

    def uniform(scale, shape):
        return rng.uniform(-scale, scale, shape).astype(np.float32)

    arrays = {"embedding": uniform(0.1, (config.vocab_size, config.emb_sz))}
    for li in range(config.n_layers):
        H, in_dim = config.layer_size(li), config.layer_in_dim(li)
        s = 1.0 / float(np.sqrt(H))
        arrays[f"lstm_{li}_w_ih"] = uniform(s, (4 * H, in_dim))
        arrays[f"lstm_{li}_w_hh"] = uniform(s, (4 * H, H))
        arrays[f"lstm_{li}_bias"] = uniform(s, (4 * H,))
    return arrays


class AWDLSTMEncoder(nn.Module):
    """Embedding + stacked LSTM layers, frozen, in the config's dtype.

    Parameter names are the export's flat keys (``embedding``,
    ``lstm_{i}_w_ih|w_hh|bias``). ``plain=True`` runs each recurrence
    through K1's plain PyTorch version on any device; it is the reference
    the kernel path is held against on the card.
    """

    def __init__(self, config: AWDLSTMConfig, device="cpu",
                 plain: bool = False):
        super().__init__()
        self.config = config
        self.plain = plain
        kw = {"dtype": config.torch_dtype, "device": device}

        def param(*shape):
            return nn.Parameter(torch.empty(shape, **kw), requires_grad=False)

        self.embedding = param(config.vocab_size, config.emb_sz)
        for li in range(config.n_layers):
            H, in_dim = config.layer_size(li), config.layer_in_dim(li)
            setattr(self, f"lstm_{li}_w_ih", param(4 * H, in_dim))
            setattr(self, f"lstm_{li}_w_hh", param(4 * H, H))
            setattr(self, f"lstm_{li}_bias", param(4 * H))

    def forward(self, tokens: torch.Tensor,
                states: Tuple[LSTMState, ...]):
        """``tokens (B, T)`` ids -> ``(raw_output (B, T, emb_sz),
        new_states)``."""
        layer = lstm_layer if self.plain else lstm_layer_fused
        x = self.embedding[tokens.long()]  # (B, T, E)
        new_states = []
        for li in range(self.config.n_layers):
            x, st = layer(
                x, states[li],
                getattr(self, f"lstm_{li}_w_ih"),
                getattr(self, f"lstm_{li}_w_hh"),
                getattr(self, f"lstm_{li}_bias"))
            new_states.append(st)
        return x, tuple(new_states)

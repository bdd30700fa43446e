"""AWD-LSTM encoder and language model.

Port of the JAX package's ``models/awd_lstm.py``: ``AWDLSTMEncoder``
(embedding gather, then N stacked recurrent layers) and ``AWDLSTMLM`` (the
encoder plus the tied decoder). An LSTM layer is an input projection plus
a fused recurrence from ``ops/fused_lstm.py``, routed as the JAX encoder
routes its Pallas branches:

* ``precision="int8"``: K3 (int8 ``W_hh``, per-row scales), always;
* f32/bf16 weights with ``valid_lens``: K2 (the ragged scheduler);
* f32/bf16 weights without: ``lstm_layer_fused``, which runs K4 and K5
  when autograd needs gradients (training) and K1 otherwise (the dense
  ``slots`` and ``groups`` paths, evaluation).

A QRNN layer (``qrnn=True``) is ``ops/qrnn.py::qrnn_layer``: K8 with
``valid_lens``, otherwise K6 (and K7 in training), under int8 on its gate
weight dequantized in the compute dtype.

Training uses the five AWD dropouts, each with one mask per window
(:func:`draw_dropout_masks`). The sequence-parallel axis is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from code_intelligence_tpu_torch.ops.fused_lstm import (
    lstm_layer_fused,
    lstm_layer_fused_ragged,
    lstm_layer_fused_ragged_int8,
    pack_w_hh_fwd,
    tc_layout,
)
from code_intelligence_tpu_torch.ops.lstm import LSTMState, lstm_layer
from code_intelligence_tpu_torch.ops.qrnn import qrnn_layer
from code_intelligence_tpu_torch.ops.quantize import SCALE_SUFFIX, tree_bytes

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AWDLSTMConfig:
    """Reads every key of the JAX package's ``model_config.json``.

    ``lstm_use_pallas`` and ``qrnn_use_pallas`` are accepted and ignored:
    the port has one kernel path on CUDA. The dropout rates are used in
    training only.
    ``precision="int8"`` is the serve-path weight precision that the
    engine sets when it quantizes at load (``ops/quantize.py``).
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
        if self.precision not in ("f32", "int8"):
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

    def qrnn_window(self, layer: int) -> int:
        """The QRNN convolution's width: 2 for layer 0, 1 above it."""
        return 2 if layer == 0 else 1


def init_lstm_states(config: AWDLSTMConfig, batch_size: int,
                     device="cpu") -> Tuple[LSTMState, ...]:
    """Zero carried state per layer in the compute dtype: LSTM ``(h, c)``,
    each ``(batch_size, H)``; QRNN ``(h, x_prev)``, ``x_prev`` the layer's
    last input ``(batch_size, in_dim)``."""
    states = []
    for li in range(config.n_layers):
        h = torch.zeros((batch_size, config.layer_size(li)),
                        dtype=config.torch_dtype, device=device)
        second = (h.new_zeros((batch_size, config.layer_in_dim(li)))
                  if config.qrnn else torch.zeros_like(h))
        states.append((h, second))
    return tuple(states)


def random_encoder_arrays(config: AWDLSTMConfig, seed: int = 0) -> dict:
    """Random f32 encoder weights in the export's flat layout, from a numpy
    seed, with the JAX package's init ranges: U(-0.1, 0.1) for the
    embedding and U(-1/sqrt(H), 1/sqrt(H)) for each LSTM tensor and QRNN
    gate weight (QRNN biases are zeros)."""
    rng = np.random.default_rng(seed)

    def uniform(scale, shape):
        return rng.uniform(-scale, scale, shape).astype(np.float32)

    arrays = {"embedding": uniform(0.1, (config.vocab_size, config.emb_sz))}
    for li in range(config.n_layers):
        H, in_dim = config.layer_size(li), config.layer_in_dim(li)
        s = 1.0 / float(np.sqrt(H))
        if config.qrnn:
            arrays[f"qrnn_{li}_w"] = uniform(
                s, (3 * H, config.qrnn_window(li) * in_dim))
            arrays[f"qrnn_{li}_b"] = np.zeros((3 * H,), np.float32)
            continue
        arrays[f"lstm_{li}_w_ih"] = uniform(s, (4 * H, in_dim))
        arrays[f"lstm_{li}_w_hh"] = uniform(s, (4 * H, H))
        arrays[f"lstm_{li}_bias"] = uniform(s, (4 * H,))
    return arrays


def draw_dropout_masks(config: AWDLSTMConfig, batch_size: int,
                       generator: torch.Generator, device="cpu") -> dict:
    """One window's AWD dropout masks, as boolean keep masks drawn from
    ``generator`` (each element kept with probability ``1 - p``); a rate
    of 0 draws nothing:

    * ``embed`` ``(V, 1)``: whole rows of the embedding table;
    * ``input`` ``(B, 1, emb_sz)``, ``hidden_{i}`` ``(B, 1, H_i)`` for all
      but the last layer, ``output`` ``(B, 1, emb_sz)``: locked dropout,
      one mask reused across time;
    * ``weight_{i}``: DropConnect on layer i's ``W_hh`` ``(4H_i, H_i)``,
      or on a QRNN layer's gate weight ``(3H_i, window * in_dim)``.
    """
    def keep(p, *shape):
        return torch.rand(shape, generator=generator, device=device) < 1 - p

    cfg = config
    masks = {}
    if cfg.embed_p > 0:
        masks["embed"] = keep(cfg.embed_p, cfg.vocab_size, 1)
    if cfg.input_p > 0:
        masks["input"] = keep(cfg.input_p, batch_size, 1, cfg.emb_sz)
    for li in range(cfg.n_layers):
        H = cfg.layer_size(li)
        if cfg.weight_p > 0:
            masks[f"weight_{li}"] = keep(cfg.weight_p, *(
                (3 * H, cfg.qrnn_window(li) * cfg.layer_in_dim(li))
                if cfg.qrnn else (4 * H, H)))
        if li < cfg.n_layers - 1 and cfg.hidden_p > 0:
            masks[f"hidden_{li}"] = keep(cfg.hidden_p, batch_size, 1, H)
    if cfg.output_p > 0:
        masks["output"] = keep(cfg.output_p, batch_size, 1, cfg.emb_sz)
    return masks


def _scaled(keep: torch.Tensor, p: float, dtype: torch.dtype):
    """A keep mask as the JAX package applies it: ``keep / (1 - p)`` in
    the compute dtype."""
    return keep.to(dtype) / (1.0 - p)


class AWDLSTMEncoder(nn.Module):
    """Embedding + stacked LSTM or QRNN layers, in the config's dtype.

    Parameter names are the export's flat keys (``embedding``,
    ``lstm_{i}_w_ih|w_hh|bias``, or ``qrnn_{i}_w|b``). Under
    ``precision="int8"`` the embedding and the layers' matmul weights are
    int8 codes, each with an f32 ``<name>_scale`` sibling
    (``ops/quantize.py``); biases stay in the compute dtype. ``plain=True``
    runs each recurrence through its kernel's plain PyTorch version on any
    device; it is the reference the kernel path is held against on the
    card.

    Frozen by default. ``trainable=True`` keeps f32 master weights that
    take gradients and are cast to the compute dtype in the forward, as
    the JAX model casts ``w.astype(cfg.dtype)``.

    A frozen bf16 LSTM encoder keeps each layer's ``W_hh`` packed for the
    tensor-core K1 and K2 (:meth:`w_hh_pack`), built on first use and
    reused until the weight changes; a trainable one packs per call.
    """

    def __init__(self, config: AWDLSTMConfig, device="cpu",
                 plain: bool = False, trainable: bool = False):
        super().__init__()
        self.config = config
        self.plain = plain
        self.trainable = trainable
        self.int8 = config.precision == "int8"
        self._packs = {}  # layer -> (w_hh, its storage and version, packs)
        if trainable and self.int8:
            raise ValueError("precision='int8' is a serve-path mode: "
                             "training runs f32 master weights")
        pdtype = torch.float32 if trainable else config.torch_dtype

        def param(*shape, dtype=pdtype):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=trainable)

        wdtype = torch.int8 if self.int8 else pdtype
        self.embedding = param(config.vocab_size, config.emb_sz, dtype=wdtype)
        if self.int8:
            setattr(self, "embedding" + SCALE_SUFFIX,
                    param(config.emb_sz, dtype=torch.float32))
        for li in range(config.n_layers):
            H, in_dim = config.layer_size(li), config.layer_in_dim(li)
            if config.qrnn:
                setattr(self, f"qrnn_{li}_w", param(
                    3 * H, config.qrnn_window(li) * in_dim, dtype=wdtype))
                setattr(self, f"qrnn_{li}_b", param(3 * H))
                if self.int8:
                    setattr(self, f"qrnn_{li}_w{SCALE_SUFFIX}",
                            param(3 * H, dtype=torch.float32))
                continue
            setattr(self, f"lstm_{li}_w_ih", param(4 * H, in_dim, dtype=wdtype))
            setattr(self, f"lstm_{li}_w_hh", param(4 * H, H, dtype=wdtype))
            setattr(self, f"lstm_{li}_bias", param(4 * H))
            if self.int8:
                for w in ("w_ih", "w_hh"):
                    setattr(self, f"lstm_{li}_{w}{SCALE_SUFFIX}",
                            param(4 * H, dtype=torch.float32))

    def forward(self, tokens: torch.Tensor, states: Tuple[LSTMState, ...],
                valid_lens: Optional[torch.Tensor] = None,
                t_live: Optional[int] = None, masks: Optional[dict] = None):
        """``tokens (B, T)`` ids -> ``(raw_output (B, T, emb_sz),
        new_states)``.

        ``valid_lens (B,)`` marks each row's live prefix: the layers run
        the length-aware kernels (K2, or K3 under int8), whose outputs are
        0 past it and whose carry freezes there. ``t_live``, a host int at
        least ``min(T, max(valid_lens))``, lets them launch only the live
        steps; the caller knows the lengths on the host, so no layer
        reads ``valid_lens`` back. An int8 LSTM encoder without
        ``valid_lens`` treats every token as live. QRNN layers run K8 with
        ``valid_lens`` (one launch, so ``t_live`` is not needed) and K6
        without.

        ``masks`` (training, from :func:`draw_dropout_masks`) applies the
        embedding, input, DropConnect and hidden dropouts; the output
        dropout is the language model's."""
        cfg = self.config
        dtype = cfg.torch_dtype
        B, T = tokens.shape
        masks = masks or {}
        table = self.embedding
        if "embed" in masks:  # whole rows, in f32 as the JAX model drops them
            table = table * masks["embed"] / (1.0 - cfg.embed_p)
        x = table[tokens.long()].to(dtype)  # (B, T, E)
        if self.int8:
            # dequantize after the gather: only the (B, T, E) activation,
            # never the whole table
            x = x * getattr(self, "embedding" + SCALE_SUFFIX).to(dtype)
            if valid_lens is None and not cfg.qrnn:
                valid_lens = torch.full((B,), T, dtype=torch.int32,
                                        device=tokens.device)
        if "input" in masks:
            x = x * _scaled(masks["input"], cfg.input_p, dtype)
        if valid_lens is not None:
            valid_lens = valid_lens.to(torch.int32).contiguous()
        new_states = []
        for li in range(cfg.n_layers):
            if cfg.qrnn:
                x, st = self._qrnn(li, x, states[li], valid_lens, masks)
                if f"hidden_{li}" in masks:
                    x = x * _scaled(masks[f"hidden_{li}"], cfg.hidden_p,
                                    dtype)
                new_states.append(st)
                continue
            p = f"lstm_{li}_"
            w_ih, w_hh, bias = (getattr(self, p + n)
                                for n in ("w_ih", "w_hh", "bias"))
            if self.int8:
                ih_scale, hh_scale = (getattr(self, p + n + SCALE_SUFFIX)
                                      for n in ("w_ih", "w_hh"))
                x, st = lstm_layer_fused_ragged_int8(
                    x, states[li], w_ih, ih_scale, w_hh, hh_scale, bias,
                    valid_lens, t_live, plain=self.plain)
            elif valid_lens is not None:
                x, st = lstm_layer_fused_ragged(
                    x, states[li], w_ih, w_hh, bias, valid_lens, t_live,
                    plain=self.plain, w_pack=self.w_hh_pack(li, B))
            else:
                w_ih, w_hh, bias = (w.to(dtype) for w in (w_ih, w_hh, bias))
                w_pack = self.w_hh_pack(li, B)
                if f"weight_{li}" in masks:  # DropConnect: not in the pack
                    w_hh = w_hh * _scaled(masks[f"weight_{li}"],
                                          cfg.weight_p, dtype)
                    w_pack = None
                if self.plain:
                    x, st = lstm_layer(x, states[li], w_ih, w_hh, bias)
                else:
                    x, st = lstm_layer_fused(x, states[li], w_ih, w_hh, bias,
                                             w_pack=w_pack)
            if f"hidden_{li}" in masks:
                x = x * _scaled(masks[f"hidden_{li}"], cfg.hidden_p, dtype)
            new_states.append(st)
        return x, tuple(new_states)

    def w_hh_pack(self, li: int, B: int) -> Optional[torch.Tensor]:
        """LSTM layer ``li``'s ``W_hh`` packed for the bf16 tensor-core
        K1 and K2 at batch ``B`` (``ops/fused_lstm.py::pack_w_hh_fwd``), or
        None where a layer takes none (trainable, plain, not bf16). Built
        on first use and kept while the weight is the same tensor with the
        same storage and version counter: ``load_state_dict``, any
        in-place update and a move to another device or dtype each build it
        anew. (A write through ``.data`` bypasses the version counter.)"""
        w_hh = getattr(self, f"lstm_{li}_w_hh")
        if self.trainable or self.plain or w_hh.dtype != torch.bfloat16:
            return None
        key = (w_hh.data_ptr(), w_hh.device, w_hh._version)
        held = self._packs.get(li)
        if held is None or held[0] is not w_hh or held[1] != key:
            held = self._packs[li] = (w_hh, key, {})
        lay = tc_layout(B, w_hh.shape[1])
        packs = held[2]
        if lay.rows not in packs:
            packs[lay.rows] = pack_w_hh_fwd(w_hh.detach(), lay)
        return packs[lay.rows]

    def held_bytes(self) -> int:
        """The bytes the encoder holds on its device: its weights and
        scales, and the W_hh packs it keeps (none under int8: K3 reads the
        codes where they lie)."""
        packs = [p for _, _, by_rows in self._packs.values()
                 for p in by_rows.values()]
        return tree_bytes([list(self.parameters()), packs])

    def _qrnn(self, li: int, x: torch.Tensor, state, valid_lens, masks):
        """QRNN layer ``li`` on its input ``x``: ``(out, (h_T, x[:, -1]))``.
        The gate weight is dequantized (int8) and weight-dropped in the
        compute dtype, in the JAX encoder's order of operations."""
        cfg = self.config
        dtype = cfg.torch_dtype
        w = getattr(self, f"qrnn_{li}_w").to(dtype)
        if self.int8:
            w = w * getattr(self, f"qrnn_{li}_w{SCALE_SUFFIX}").to(
                dtype)[:, None]
        if f"weight_{li}" in masks:
            w = w * masks[f"weight_{li}"].to(dtype) / (1.0 - cfg.weight_p)
        h0, x_prev = state
        window = cfg.qrnn_window(li)
        out, h_t = qrnn_layer(
            x, {"w": w, "b": getattr(self, f"qrnn_{li}_b").to(dtype)},
            h0=h0, window=window, x_prev=x_prev if window == 2 else None,
            valid_lens=valid_lens, plain=self.plain)
        return out, (h_t, x[:, -1])


class AWDLSTMLM(nn.Module):
    """Trainable encoder + the tied decoder: ``tokens (B, T)`` ->
    ``(logits (B, T, V), raw, dropped, new_states)``, where ``raw`` is the
    last layer's output and ``dropped`` is ``raw`` after the output
    dropout, as the JAX ``AWDLSTMLM`` returns them for the AR and TAR
    terms. Parameters: ``encoder.*`` (f32 masters) and ``decoder_b``
    (zeros, the JAX init)."""

    def __init__(self, config: AWDLSTMConfig, device="cpu",
                 plain: bool = False):
        super().__init__()
        if not config.tie_weights:
            raise NotImplementedError("only the tied decoder is ported")
        self.config = config
        self.encoder = AWDLSTMEncoder(config, device=device, plain=plain,
                                      trainable=True)
        if config.out_bias:
            self.decoder_b = nn.Parameter(
                torch.zeros(config.vocab_size, device=device))

    def forward(self, tokens: torch.Tensor, states: Tuple[LSTMState, ...],
                masks: Optional[dict] = None):
        cfg = self.config
        dtype = cfg.torch_dtype
        raw, new_states = self.encoder(tokens, states, masks=masks)
        dropped = raw
        if masks and "output" in masks:
            dropped = raw * _scaled(masks["output"], cfg.output_p, dtype)
        logits = dropped @ self.encoder.embedding.to(dtype).t()
        if cfg.out_bias:
            logits = logits + self.decoder_b.to(dtype)
        return logits, raw, dropped, new_states

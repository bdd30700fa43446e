"""Post-training symmetric per-channel int8 quantization for the serve
encoder (``precision="int8"``).

The port's own copy of the JAX package's ``ops/quantize.py``, in numpy:
each target weight becomes int8 codes plus one f32 scale per channel,
quantized at load from the ordinary f32 export (no new export format).
Scales are per OUTPUT channel of a matmul weight, so they can be applied
after the accumulation: ``(x @ q^T) * s`` equals ``x @ (q * s)^T`` up to
rounding, which is what kernel K3 and the int8 layer rely on.

Quantization is deterministic (numpy ``rint``, half to even): the same
checkpoint always gives bitwise the same codes and scales, and the same
ones as the JAX package's function.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

INT8_MAX = 127

#: the channel axis each target keeps (one scale per index along it)
EMBEDDING_AXIS = 1  # (vocab, emb): per embedding column
WEIGHT_AXIS = 0  # (out, in) matmul weights: per output row
SCALE_SUFFIX = "_scale"


def quantize_symmetric(w, axis: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``(q int8, scale f32)`` with ``scale = max|w| / 127`` per channel
    along ``axis`` and ``q = clip(rint(w / scale), -127, 127)``. An
    all-zero channel gets scale 1.0, so it quantizes to 0 and back to 0
    without a division by zero."""
    w_np = np.asarray(w, dtype=np.float32)
    if not -w_np.ndim <= axis < w_np.ndim:
        raise ValueError(f"axis {axis} out of range for shape {w_np.shape}")
    axis = axis % w_np.ndim
    reduce_axes = tuple(i for i in range(w_np.ndim) if i != axis)
    amax = np.max(np.abs(w_np), axis=reduce_axes) if reduce_axes else np.abs(w_np)
    scale = np.where(amax > 0.0, amax / float(INT8_MAX), 1.0).astype(np.float32)
    shape = [1] * w_np.ndim
    shape[axis] = -1
    q = np.rint(w_np / scale.reshape(shape))
    q = np.clip(q, -INT8_MAX, INT8_MAX).astype(np.int8)
    return q, scale


def quant_targets(config) -> Iterator[Tuple[str, int]]:
    """``(param name, channel axis)`` of every encoder weight that
    quantizes: the embedding table and each layer's matmul weights (LSTM
    ``w_ih`` and ``w_hh``, or the QRNN gate weight ``w``). Biases stay
    f32."""
    yield "embedding", EMBEDDING_AXIS
    for li in range(config.n_layers):
        if config.qrnn:
            yield f"qrnn_{li}_w", WEIGHT_AXIS
        else:
            yield f"lstm_{li}_w_ih", WEIGHT_AXIS
            yield f"lstm_{li}_w_hh", WEIGHT_AXIS


def quantize_encoder_params(params: Dict[str, Any],
                            config) -> Dict[str, np.ndarray]:
    """A flat f32 encoder dict -> its int8 serve form: each target
    replaced by its int8 codes plus an f32 ``<name>_scale`` sibling, every
    other entry (the biases) passed through as it is."""
    out = dict(params)
    for name, axis in quant_targets(config):
        if name not in params:
            raise KeyError(
                f"quantize_encoder_params: param {name!r} missing from the "
                f"checkpoint (have: {sorted(params)})")
        q, scale = quantize_symmetric(params[name], axis=axis)
        out[name] = q
        out[name + SCALE_SUFFIX] = scale
    return out


def tree_bytes(tree) -> int:
    """Total bytes of the arrays and tensors in a (nested) dict, list or
    tuple: the weight footprint the int8 check compares."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(np.asarray(tree).nbytes)

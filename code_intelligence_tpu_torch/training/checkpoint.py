"""Encoder export directory: loader, writer, and the weight carry-over.

An export is what the JAX package's ``training/checkpoint.py::
export_encoder`` writes and its inference engine loads:
``encoder_params.npz`` (flat keys ``embedding``,
``lstm_{i}_w_ih|w_hh|bias``), ``model_config.json`` and ``vocab.json``.
The port reads and writes the same files with numpy, so one export serves
both packages.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from code_intelligence_tpu_torch.models import AWDLSTMConfig
from code_intelligence_tpu_torch.utils.params_io import load_params_npz

CONFIG_NAME = "model_config.json"
PARAMS_NAME = "encoder_params.npz"
VOCAB_NAME = "vocab.json"


def load_encoder(model_dir) -> Tuple[dict, AWDLSTMConfig, Optional[Path]]:
    """``(encoder arrays, AWDLSTMConfig, vocab path or None)`` of an export."""
    model_dir = Path(model_dir)
    config = AWDLSTMConfig(**json.loads((model_dir / CONFIG_NAME).read_text()))
    params = load_params_npz(model_dir / PARAMS_NAME)
    vocab_path = model_dir / VOCAB_NAME
    return params, config, (vocab_path if vocab_path.exists() else None)


def export_encoder(out_dir, arrays: Dict[str, np.ndarray],
                   config: AWDLSTMConfig, vocab=None) -> Path:
    """Write an export the JAX package's engine loads too."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / PARAMS_NAME, **arrays)
    (out / CONFIG_NAME).write_text(
        json.dumps(dataclasses.asdict(config), indent=1))
    if vocab is not None:
        vocab.save(out / VOCAB_NAME)
    return out


def params_from_numpy(params: dict) -> Dict[str, torch.Tensor]:
    """JAX encoder arrays -> the port encoder's ``state_dict``.

    Takes the flat encoder dict (``{"embedding": ..., "lstm_0_w_ih": ...}``)
    or a tree that holds it under ``encoder`` or ``params``, as the JAX
    engine does. Tensors come out on the CPU: int8 arrays (the codes of a
    quantized encoder, ``ops/quantize.py``) stay int8, everything else,
    their f32 scales included, comes out f32; ``load_state_dict`` casts
    them to the encoder's dtypes and device."""
    if "embedding" in params:
        enc = params
    elif "encoder" in params:
        enc = params["encoder"]
    elif "params" in params:
        p = params["params"]
        enc = p["encoder"] if "encoder" in p else p
    else:
        raise ValueError("unrecognized params tree: no 'embedding', "
                         "'encoder' or 'params' key")
    out = {}
    for k, v in enc.items():
        a = np.asarray(v)
        out[k] = torch.from_numpy(np.array(
            a, dtype=np.int8 if a.dtype == np.int8 else np.float32))
    return out

"""Training checkpoints, the encoder export, and the weight carry-over.

* A checkpoint is one ``torch.save`` file per step under a directory
  (``step_00000012.pt``): the LM's parameters, the Adam moments, the step,
  the carried LSTM states, the dropout generator's state and
  ``lr_scale``, everything a run needs to go on exactly where it stopped.
* An export is what the JAX package's ``training/checkpoint.py::
  export_encoder`` writes and its inference engine loads:
  ``encoder_params.npz`` (flat keys ``embedding``,
  ``lstm_{i}_w_ih|w_hh|bias``), ``model_config.json`` and ``vocab.json``.
  The port reads and writes the same files with numpy, so one export
  serves both packages.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from code_intelligence_tpu_torch.models import AWDLSTMConfig
from code_intelligence_tpu_torch.utils.params_io import load_params_npz

CKPT_RE = re.compile(r"^step_(\d+)\.pt$")
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


def lm_params_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """The JAX LM's params (numpy or jax arrays: the ``encoder`` subtree
    and ``decoder_b``, optionally under ``params``) -> the port
    ``AWDLSTMLM``'s ``state_dict``, f32 on the CPU."""
    p = params.get("params", params)
    out = {f"encoder.{k}": v for k, v in params_from_numpy(p).items()}
    if "decoder_b" in p:
        out["decoder_b"] = torch.from_numpy(
            np.array(p["decoder_b"], dtype=np.float32))
    return out


def encoder_arrays(model) -> Dict[str, np.ndarray]:
    """A trained ``AWDLSTMLM``'s encoder weights as f32 numpy arrays in
    the export's flat layout."""
    return {k: v.detach().float().cpu().numpy()
            for k, v in model.encoder.state_dict().items()}


def save_checkpoint(ckpt_dir, state, step: Optional[int] = None) -> Path:
    """Write ``state`` (a ``TrainState``) as ``step_<step>.pt``; the file
    appears whole or not at all."""
    step = state.step if step is None else step
    path = Path(ckpt_dir)
    path.mkdir(parents=True, exist_ok=True)
    target = path / f"step_{step:08d}.pt"
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    torch.save({
        "step": state.step,
        "params": state.model.state_dict(),
        "opt_state": state.opt_state,
        "lstm_states": state.lstm_states,
        "generator": state.generator.get_state(),
        "lr_scale": state.lr_scale,
    }, tmp)
    os.replace(tmp, target)
    return target


def latest_step(ckpt_dir) -> Optional[int]:
    path = Path(ckpt_dir)
    if not path.is_dir():
        return None
    steps = [int(m.group(1)) for f in path.iterdir()
             if (m := CKPT_RE.match(f.name))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir, state, step: Optional[int] = None):
    """Load a checkpoint into ``state`` (a ``TrainState`` of the same
    model and batch size, on any device) in place and return it."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    device = next(state.model.parameters()).device
    ckpt = torch.load(Path(ckpt_dir) / f"step_{step:08d}.pt",
                      map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["params"])
    for name, moments in ckpt["opt_state"].items():
        for k, v in moments.items():
            state.opt_state[name][k].copy_(v)
    state.lstm_states = tuple((h, c) for h, c in ckpt["lstm_states"])
    state.generator.set_state(ckpt["generator"].cpu())
    state.step = int(ckpt["step"])
    state.lr_scale = float(ckpt["lr_scale"])
    return state

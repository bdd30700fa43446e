"""Shared inputs for the port parity tests (tests/test_torch_*.py).

Weights and inputs come from numpy seeds and go to both packages as numpy
arrays; the JAX side writes the export with its own ``export_encoder``
and the port loads it with its own loader.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from code_intelligence_tpu.models import AWDLSTMConfig
from code_intelligence_tpu.text import SPECIALS, Vocab
from code_intelligence_tpu.training.checkpoint import export_encoder

# The port tests run at tiny sizes beside the other xdist workers; one
# intra-op thread each keeps them from crowding those workers' CPU.
torch.set_num_threads(1)

# the JAX suite's tiny model (tests/test_slot_scheduler.py::make_engine)
TINY = {"vocab_size": 200, "emb_sz": 8, "n_hid": 12}

MARKDOWN_DOCS = [
    "Crash on startup when `config.yaml` is missing",
    "## Steps\n\n1. run `kfctl apply`\n2. see error\n\n```\nTraceback:\n"
    "  File \"x.py\", line 3\n```\n\nExpected: **no** crash!!!!",
    "- [ ] check [the docs](https://www.kubeflow.org/docs/) first\n"
    "- [x] Tried @jlewi's fix in #1234 — didn't help",
    "Unicode: naïve café Ünïcödé 日本語 emoji 🚀 and\ttabs",
    "> quoted reply\n\n<details><summary>Logs</summary>ERROR ERROR "
    "ERROR ERROR</details>\n\n---\n\nWORKS ON MY MACHINE",
    "",
]


def numpy_encoder_arrays(cfg, seed: int = 0) -> dict:
    """Flat f32 encoder arrays in the export layout, U(-s, s) per tensor."""
    rng = np.random.default_rng(seed)
    out = {"embedding": rng.uniform(-0.1, 0.1, (cfg.vocab_size, cfg.emb_sz))}
    for li in range(cfg.n_layers):
        H = cfg.layer_size(li)
        n_in = cfg.emb_sz if li == 0 else cfg.n_hid
        s = 1.0 / np.sqrt(H)
        out[f"lstm_{li}_w_ih"] = rng.uniform(-s, s, (4 * H, n_in))
        out[f"lstm_{li}_w_hh"] = rng.uniform(-s, s, (4 * H, H))
        out[f"lstm_{li}_bias"] = rng.uniform(-s, s, (4 * H,))
    return {k: v.astype(np.float32) for k, v in out.items()}


def tiny_vocab() -> Vocab:
    return Vocab(SPECIALS + [f"w{i}" for i in range(150)])


def write_jax_export(out_dir, n_layers: int = 3, dtype=jnp.float32,
                     seed: int = 0):
    """A tiny export written by the JAX package; returns (dir, arrays)."""
    cfg = AWDLSTMConfig(n_layers=n_layers, dtype=dtype, **TINY)
    arrays = numpy_encoder_arrays(cfg, seed)
    export_encoder(out_dir, {k: jnp.asarray(v) for k, v in arrays.items()},
                   cfg, tiny_vocab())
    return out_dir, arrays


def mixed_seqs(n: int = 13, seed: int = 0):
    """Mixed lengths: sub-chunk, multi-chunk, an empty doc, and a doc
    longer than the largest bucket (16)."""
    rng = np.random.RandomState(seed)
    seqs = [rng.randint(20, 150, rng.randint(1, 50)).astype(np.int32)
            for _ in range(n)]
    seqs.append(np.zeros((0,), np.int32))
    seqs.append(np.arange(30, 75, dtype=np.int32))
    return seqs


def k1_inputs(T, B, H, seed=0):
    """x_proj (T, B, 4H), w_hh (4H, H), h0, c0 (B, H) as f32 numpy."""
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(H)
    return (rng.normal(0, 1, (T, B, 4 * H)).astype(np.float32),
            rng.uniform(-s, s, (4 * H, H)).astype(np.float32),
            rng.normal(0, 0.5, (B, H)).astype(np.float32),
            rng.normal(0, 0.5, (B, H)).astype(np.float32))

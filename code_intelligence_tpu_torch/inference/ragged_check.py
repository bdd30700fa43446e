"""Ragged-vs-dense acceptance check, the port's twin of the JAX package's
``inference/ragged_check.py``.

On a small randomly initialized engine and the committed mixed-length
fixture (``fixtures/ragged_lengths.json``, the port's own copy: frozen
literal lengths), it asserts:

* parity: the ragged scheduler's embeddings equal the dense ``slots``
  scheduler's within atol/rtol 1e-5 (a scheduler that changes answers is
  not a scheduler);
* cost: stepped lane-tokens per valid token on the ragged path are at
  most ``max_ratio`` (0.6) times the dense path's. Both counts come from
  the schedulers' host staging blocks; they stand in for the JAX gate's
  AOT flops per token, which scale with the same lane-tokens.

The JAX gate's transfer and recompile audits have no port counterpart
yet (ROADMAP queue 1 item 4).

    python -m code_intelligence_tpu_torch.inference.ragged_check [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

#: the committed mixed-length acceptance fixture
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "ragged_lengths.json"


def tiny_engine(device="cuda", batch_size: int = 8, **kw):
    """A small randomly initialized engine (emb 16, hidden 48, two
    layers) with the production geometry ratio: chunk 64, page 16."""
    from code_intelligence_tpu_torch.inference.engine import InferenceEngine
    from code_intelligence_tpu_torch.models import (
        AWDLSTMConfig, random_encoder_arrays)
    from code_intelligence_tpu_torch.text import SPECIALS, Vocab

    cfg = AWDLSTMConfig(vocab_size=160, emb_sz=16, n_hid=48, n_layers=2)
    vocab = Vocab(SPECIALS + [f"w{i}" for i in range(160 - len(SPECIALS))])
    return InferenceEngine(random_encoder_arrays(cfg, seed=0), cfg, vocab,
                           buckets=(32, 64), batch_size=batch_size,
                           device=device, **kw)


def fixture_ids(fixture: Optional[Path], vocab_size: int) -> List[np.ndarray]:
    """The fixture's documents: seeded random ids at its lengths."""
    spec = json.loads(Path(fixture or FIXTURE).read_text())
    rng = np.random.RandomState(int(spec.get("seed", 0)))
    return [rng.randint(5, vocab_size - 1, int(n)).astype(np.int32)
            for n in spec["lengths"]]


def run_ragged_check(fixture: Optional[Path] = None, max_ratio: float = 0.6,
                     device="cuda") -> dict:
    """Run the fixture through both schedulers; ``ok`` as the module
    docstring says."""
    engine = tiny_engine(device)
    ids = fixture_ids(fixture, engine.config.vocab_size)
    dense = engine.embed_ids_batch(ids, scheduler="slots")
    ragged = engine.embed_ids_batch(ids, scheduler="ragged")
    parity = float(np.max(np.abs(dense - ragged))) if ids else 0.0
    parity_ok = bool(np.allclose(ragged, dense, atol=1e-5, rtol=1e-5))
    ds, rs = engine.slot_scheduler(), engine.ragged_scheduler()
    per_token_dense = ds.tokens_stepped / max(ds.tokens_valid, 1)
    per_token_ragged = rs.tokens_stepped / max(rs.tokens_valid, 1)
    ratio = per_token_ragged / max(per_token_dense, 1e-9)
    return {
        "fixture": str(fixture or FIXTURE),
        "device": str(engine.device),
        "n_docs": len(ids),
        "total_tokens": int(sum(len(i) for i in ids)),
        "chunk_len": ds.chunk_len,
        "page_len": rs.page_len,
        "parity_max_abs_diff": parity,
        "parity_ok": parity_ok,
        "dense_wasted_lane_fraction": ds.wasted_lane_fraction(),
        "ragged_wasted_lane_fraction": rs.wasted_lane_fraction(),
        "lane_tokens_per_token_dense": per_token_dense,
        "lane_tokens_per_token_ragged": per_token_ragged,
        "lane_tokens_per_token_ratio": ratio,
        "max_ratio": max_ratio,
        "ok": bool(parity_ok and ratio <= max_ratio),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    result = run_ragged_check(device=args.device)
    print(json.dumps({"ragged": result}))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

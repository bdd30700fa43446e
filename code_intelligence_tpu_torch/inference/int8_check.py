"""Int8-vs-f32 serve acceptance check, the port's twin of the JAX
package's ``inference/int8_check.py``.

An f32 and an int8 engine from the SAME random f32 weights (the int8 one
quantizes at load, as a serve boot does) embed the committed
mixed-length fixture (``fixtures/ragged_lengths.json``) on the ragged
scheduler. The check asserts:

* parity band: int8 embeddings within atol/rtol 0.05 of f32 (int8 is
  lossy by construction, but boundedly so);
* footprint: the f32 encoder weights are at least
  ``min_footprint_ratio`` (3x) the int8 ones (codes plus f32 scales and
  biases, so about 3.5x rather than 4x).

The JAX check's label-head AUC band is left out: it needs the repo MLP
label head, which is not ported yet (ROADMAP queue 1 item 9). Its
transfer and recompile audits have no port counterpart yet either.

    python -m code_intelligence_tpu_torch.inference.int8_check [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from code_intelligence_tpu_torch.inference.ragged_check import (
    FIXTURE,
    fixture_ids,
    tiny_engine,
)


def run_int8_check(fixture: Optional[Path] = None, atol: float = 0.05,
                   rtol: float = 0.05, min_footprint_ratio: float = 3.0,
                   device="cuda") -> dict:
    """Run the fixture through the f32 and int8 engines; ``ok`` as the
    module docstring says."""
    f32 = tiny_engine(device)
    int8 = tiny_engine(device, precision="int8")
    ids = fixture_ids(fixture, f32.config.vocab_size)
    ref = f32.embed_ids_batch(ids, scheduler="ragged")
    got = int8.embed_ids_batch(ids, scheduler="ragged")
    parity = float(np.max(np.abs(ref - got))) if ids else 0.0
    parity_ok = bool(np.allclose(got, ref, atol=atol, rtol=rtol))
    ratio = int8.weight_bytes_f32 / max(int8.weight_bytes, 1)
    return {
        "fixture": str(fixture or FIXTURE),
        "device": str(int8.device),
        "n_docs": len(ids),
        "precision": int8.precision,
        "parity_max_abs_diff": parity,
        "parity_atol": atol,
        "parity_rtol": rtol,
        "parity_ok": parity_ok,
        "weight_bytes_f32": int(int8.weight_bytes_f32),
        "weight_bytes_int8": int(int8.weight_bytes),
        "footprint_ratio": ratio,
        "min_footprint_ratio": min_footprint_ratio,
        "footprint_ok": bool(ratio >= min_footprint_ratio),
        "auc": "not ported (needs the label heads)",
        "ok": bool(parity_ok and ratio >= min_footprint_ratio),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    result = run_int8_check(device=args.device)
    print(json.dumps({"int8": result}))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

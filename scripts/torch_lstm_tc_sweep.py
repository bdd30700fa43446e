#!/usr/bin/env python3
"""Tile sweep of the bf16 tensor-core K4 and K5, on the card.

    python3 scripts/torch_lstm_tc_sweep.py base kTcBwdRows=80 kTcKSplit=1

Run from the root of a checkout on a machine with a CUDA card. Each
argument is one variant of ``csrc/fused_lstm.cu``: the tensor-core
constants it overrides (``kTcFwdRows``, ``kTcBwdRows``, ``kTcKSplit``,
``kTcStages``), comma-separated, or ``base`` for the source as it is. A
variant is built from a copy of the source under ``build/``, held against
the plain versions at (T, B, H) = (5, 13, 37) and (67, 104, 2500) within
``chip_smoke.py``'s bounds, and timed by CUDA events (ms a call) at T=67,
B=104, H=2500 and H=800, and at B=8, where a step has almost no MMA work.
Prints the card's name and power limit, then one JSON object a variant.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lstm_tc_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from code_intelligence_tpu_torch.ops import _build
    from code_intelligence_tpu_torch.ops import fused_lstm as K

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0])
    source = (_build.CSRC_DIR / "fused_lstm.cu").read_text()
    rows = (K.TC_FWD_ROWS, K.TC_BWD_ROWS)
    bf16 = torch.bfloat16
    for i, variant in enumerate(sys.argv[1:] or ["base"]):
        consts = dict(kv.split("=") for kv in variant.split(",")
                      if variant != "base")
        src = source
        for name, value in consts.items():
            src, n = re.subn(rf"(constexpr int {name} = )\d+;",
                             rf"\g<1>{value};", src)
            if n != 1:
                raise SystemExit(f"no constant {name} in fused_lstm.cu")
        csrc = REPO / "build" / "tc_sweep" / str(i)
        csrc.mkdir(parents=True, exist_ok=True)
        (csrc / "fused_lstm.cu").write_text(src)
        _build.CSRC_DIR, _build._libs = csrc, {}  # this variant's library
        K.TC_FWD_ROWS = int(consts.get("kTcFwdRows", rows[0]))
        K.TC_BWD_ROWS = int(consts.get("kTcBwdRows", rows[1]))
        out = {"variant": variant, "max_abs_err": {}, "ms": {}}
        for shape in ((5, 13, 37), (67, 104, 2500)):
            out["max_abs_err"][f"K4 {shape}"] = smoke.check_k4(*shape, bf16)
            out["max_abs_err"][f"K5 {shape}"] = smoke.check_k5(*shape, bf16)
        for B, H in ((104, 2500), (104, 800), (8, 2500)):
            fwd = smoke.k1_inputs(67, B, H, bf16)
            bwd = smoke.k5_inputs(67, B, H, bf16)
            out["ms"][f"K4 B{B} H{H}"] = smoke.cuda_ms(
                lambda: K.fused_lstm_forward(*fwd, with_gates=True), reps=5)
            out["ms"][f"K5 B{B} H{H}"] = smoke.cuda_ms(
                lambda: K.fused_lstm_backward(*bwd), reps=5)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

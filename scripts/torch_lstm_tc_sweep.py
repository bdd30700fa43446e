#!/usr/bin/env python3
"""Tile sweep of the bf16 tensor-core kernels, on the card.

    python3 scripts/torch_lstm_tc_sweep.py base kTcBwdRows=80 kTcKSplit=1
    python3 scripts/torch_lstm_tc_sweep.py base kTcServeRows=32 \
        kTcServeStages=8,kTcServeKSplit=1

Run from the root of a checkout on a machine with a CUDA card. Each
argument is one variant of ``csrc/fused_lstm.cu``: the tensor-core
constants it overrides (``kTcFwdRows``, ``kTcBwdRows``, ``kTcKSplit``,
``kTcStages``; the serve tile's ``kTcServeRows``, ``kTcServeStages``,
``kTcServeKSplit``), comma-separated, or ``base`` for the source as it
is. The variants are built together, each from a copy of the source
under ``build/``. Each holds K1 at the slot step (T=64, B=32) and K2 at
the ragged step (T=16, B=32, the lengths of ``chip_smoke.py``'s timing)
against their plain versions at H=2500 and times both at H=2500 and
H=800, on ``W_hh`` packed beforehand as a served model holds it; then
holds K4 and K5 against theirs at (T, B, H) = (5, 13, 37) and (67, 104,
2500) and times them at T=67, B=104, H=2500 and H=800, and at B=8,
where a step has almost no MMA work: ms a call by CUDA events, every
check within ``chip_smoke.py``'s bounds. Prints the card's name and power limit, then one
JSON object a variant. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
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
    rows = (K.TC_FWD_ROWS, K.TC_BWD_ROWS, K.TC_SERVE_ROWS)
    bf16 = torch.bfloat16
    variants = []
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
        variants.append((variant, consts, csrc))
    # one nvcc a variant, all at once, into the library name load() takes
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, builds = [_build.nvcc_path(), *_build.NVCC_FLAGS], []
    for _, _, csrc in variants:
        src = csrc / "fused_lstm.cu"
        lib = _build._target("fused_lstm", src.read_bytes())
        builds.append(subprocess.Popen([*nvcc, "-o", str(lib), str(src)]))
    for b in builds:
        b.wait()
    for variant, consts, csrc in variants:
        _build.CSRC_DIR, _build._libs = csrc, {}  # this variant's library
        K.TC_FWD_ROWS = int(consts.get("kTcFwdRows", rows[0]))
        K.TC_BWD_ROWS = int(consts.get("kTcBwdRows", rows[1]))
        K.TC_SERVE_ROWS = int(consts.get("kTcServeRows", rows[2]))
        out = {"variant": variant, "max_abs_err": {}, "ms": {}}
        serve(smoke, K, out)
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


def serve(smoke, K, out: dict) -> None:
    """K1 at the slot step and K2 at the ragged step, bf16: held against
    the plain versions at H=2500, timed at H=2500 and H=800."""
    bf16 = torch.bfloat16
    rng = np.random.default_rng(smoke.SEED + 3)
    valid = [int(v) for v in rng.integers(1, 17, 32)]
    valid[0] = 16
    out["max_abs_err"]["K1 (64, 32, 2500)"] = smoke.check_k1(64, 32, 2500,
                                                             bf16)
    out["max_abs_err"]["K2 (16, 32, 2500)"] = smoke.check_ragged(
        16, 32, 2500, bf16, valid, int8=False)
    for H in (2500, 800):
        k1 = smoke.k1_inputs(64, 32, H, bf16)
        k1_pack, _ = smoke.serve_pack(k1[1], 32)
        out["ms"][f"K1 T64 B32 H{H}"] = smoke.cuda_ms(
            lambda: K.fused_lstm_forward(*k1, w_pack=k1_pack), reps=10)
        k2 = smoke.ragged_inputs(16, 32, H, bf16, valid, int8=False)
        k2_pack, _ = smoke.serve_pack(k2[1], 32)
        out["ms"][f"K2 T16 B32 H{H}"] = smoke.cuda_ms(
            lambda: K.fused_lstm_forward_ragged(*k2, t_live=16,
                                                w_pack=k2_pack), reps=20)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Per-step device time of the port's K1 kernel (fused LSTM forward).

    python3 scripts/torch_k1_profile.py

Run from the root of a checkout on a machine with a CUDA card. Times one
bf16 call of T=64 steps with CUDA events at several widths and batch
sizes, on ``W_hh`` packed beforehand as a served model holds it, then
traces one flagship call with ``torch.profiler`` to read the kernel's own
device time (the tensor-core step in bf16), which separates the kernel
from host launch gaps. Prints one JSON object; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import cuda_ms, k1_inputs, serve_pack  # noqa: E402
from code_intelligence_tpu_torch.ops import fused_lstm as K1  # noqa: E402

T = 64  # the slot step's chunk


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k1_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    out = {"card": card, "T": T, "dtype": "bfloat16", "us_per_step": {}}
    for H, B in ((8, 32), (800, 32), (2500, 32), (2500, 16), (2500, 1)):
        args = k1_inputs(T, B, H, torch.bfloat16)
        pack, _ = serve_pack(args[1], B)
        ms = cuda_ms(lambda: K1.fused_lstm_forward(*args, w_pack=pack),
                     reps=5)
        out["us_per_step"][f"H{H}_B{B}"] = ms * 1e3 / T
    args = k1_inputs(T, 32, 2500, torch.bfloat16)
    pack, _ = serve_pack(args[1], 32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    K1.fused_lstm_forward(*args, w_pack=pack)
    out["host_enqueue_ms_H2500_B32"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        K1.fused_lstm_forward(*args, w_pack=pack)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if "lstm_step" in e.key or "lstm_fwd_tc_step" in e.key:
            out["profiler_H2500_B32"] = {
                "kernel": e.key, "count": e.count,
                "device_us_per_launch": e.device_time_total / e.count}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

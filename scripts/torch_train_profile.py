#!/usr/bin/env python3
"""Where a training window's time goes, on the card.

    python3 scripts/torch_train_profile.py [--qrnn]

Run from the root of a checkout on a machine with a CUDA card. Builds
the port's ``LMTrainer`` at flagship width (vocab 60,000, emb 800, hidden
2500/2500/2500/800, bf16 compute, f32 masters, the reference's dropouts)
at B=104, bptt 67, on tokens from a numpy seed, with LSTM layers or, with
``--qrnn``, QRNN layers; warms two windows, then traces two with
``torch.profiler``. Prints one JSON object: the window's wall time, the
device time by kernel (the twelve largest by PyTorch's kernel names,
and K4 and K5, or K6 and K7, by name wherever they rank) and the
device's busy share of the wall time. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
B, T, SEED, WARM, TRACED = 104, 67, 0, 2, 2


def kernel_name(key: str) -> str:
    """K1-K7 by name. In bf16, K1, K4 and K5 are the tensor-core steps,
    the forward one told apart by its FwdKind argument (0 K1, 1 K2, 2 K4,
    3 K3);
    in f32 K4 is lstm_step's kGates instantiation (its last template
    argument true), mangled or demangled."""
    if "lstm_fwd_tc_step" in key:
        kind = [k for i, k in enumerate(("K1", "K2", "K4", "K3"))
                if f"FwdKind){i}" in key or f"FwdKindE{i}E" in key]
        return f"{kind[0] if kind else 'K1-K4'} lstm_fwd_tc_step"
    if "lstm_bwd_tc_step" in key:
        return "K5 lstm_bwd_tc_step"
    if "forget_mult_bwd" in key:
        return "K7 forget_mult_bwd"
    if "forget_mult_fwd" in key:
        return "K6 forget_mult_fwd"
    if "lstm_bwd_step" in key:
        return "K5 lstm_bwd_step"
    if "lstm_step" in key:
        gates = key.split(">(")[0].endswith("true") or "Lb1EEEv" in key
        return "K4 lstm_step (gates)" if gates else "K1 lstm_step"
    return key


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from code_intelligence_tpu_torch.models import AWDLSTMConfig
    from code_intelligence_tpu_torch.training.loop import (LMTrainer,
                                                           TrainConfig)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    cfg = AWDLSTMConfig(vocab_size=60000, emb_sz=800, n_hid=2500,
                        n_layers=4, dtype="bfloat16",
                        qrnn="--qrnn" in sys.argv[1:])
    trainer = LMTrainer(cfg, TrainConfig(batch_size=B, bptt=T),
                        device="cuda")
    state = trainer.init_state(SEED)
    rng = np.random.default_rng(SEED)
    windows = [rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
               for _ in range(WARM + TRACED)]
    for w in windows[:WARM]:
        state, _ = trainer.train_step(state, w[:, :-1], w[:, 1:])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for w in windows[WARM:]:
            state, m = trainer.train_step(state, w[:, :-1], w[:, 1:])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / TRACED
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_time_total <= 0 or not str(e.device_type).endswith(
                "CUDA"):
            continue  # CPU ops: their kernels are listed on their own
        d = by_kernel.setdefault(kernel_name(e.key),
                                 {"device_ms": 0.0, "launches": 0})
        d["device_ms"] += e.device_time_total / 1e3 / TRACED
        d["launches"] += e.count // TRACED
    device_ms = sum(d["device_ms"] for d in by_kernel.values())
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1]["device_ms"])
    # the twelve largest, and the port's own kernels wherever they rank
    top = {k: v for i, (k, v) in enumerate(ranked)
           if i < 12 or k.startswith("K")}
    print(json.dumps({
        "card": card, "qrnn": cfg.qrnn,
        "shape": {"B": B, "T": T, "dtype": "bfloat16"},
        "window_ms": wall_ms, "tokens_per_s": B * T / wall_ms * 1e3,
        "device_ms_per_window": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "by_kernel_per_window": top,
        "last_loss": float(m["loss"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

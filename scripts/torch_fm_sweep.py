#!/usr/bin/env python3
"""Constant sweep of the ring kernels K6 and K8, on the card.

    python3 scripts/torch_fm_sweep.py base kGroup=2 kGroup=8,kRingBytes=65536

Run from the root of a checkout on a machine with a CUDA card. Each
argument is one variant of ``csrc/forget_mult.cu``: the ring constants
it overrides (``kGroup``, ``kSpecGroups``, ``kRingBytes``, ``kLanes``,
``kRingWarps``), comma-separated, or ``base`` for the source as it is. The variants are
built together, one ``nvcc`` each, from copies of the source under
``build/fm_sweep/``. Each then runs ``chip_smoke.py``'s QRNN checks (K6
and K8 bit for bit against their plain loops, K7 within its bound) and
its QRNN timing (device time by ``torch.profiler`` after an L2 flush,
``ms``, and back to back, ``ms_warm``: K6 at the slot step and the
training shape, K7 at the training shape, K8 at the ragged step; bf16,
H=2500). Prints the card's name and power limit, then one JSON object a
variant with ptxas's resource lines. Imports nothing of JAX.
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
        print("torch_fm_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from code_intelligence_tpu_torch.ops import _build

    print(smoke.card_line(), flush=True)
    source = (_build.CSRC_DIR / "forget_mult.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    builds = []
    for i, variant in enumerate(sys.argv[1:] or ["base"]):
        src = source
        for kv in [] if variant == "base" else variant.split(","):
            name, value = kv.split("=")
            src, n = re.subn(rf"(constexpr int {name} = )[^;]+;",
                             rf"\g<1>{value};", src)
            if n != 1:
                raise SystemExit(f"no constant {name} in forget_mult.cu")
        csrc = REPO / "build" / "fm_sweep" / str(i)
        csrc.mkdir(parents=True, exist_ok=True)
        (csrc / "forget_mult.cu").write_text(src)
        # one nvcc a variant, all at once, into the library name load() takes
        lib = _build._target("forget_mult", src.encode())
        builds.append((variant, csrc, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-o",
             str(lib), str(csrc / "forget_mult.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for variant, csrc, proc in builds:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {variant}:\n{log}")
        _build.CSRC_DIR, _build._libs = csrc, {}  # this variant's library
        errs = smoke.qrnn_kernel_checks()
        timing = {k: v for k, v in smoke.qrnn_timing_phase().items()
                  if isinstance(v, dict)}
        print(json.dumps({
            "variant": variant,
            "ptxas": [line.strip() for line in log.splitlines()
                      if any(k in line for k in ("entry", "Used", "spill"))],
            "max_abs_err": {k: max(v.values()) for k, v in errs.items()},
            "ms": {k: v["ms"] for k, v in timing.items()},
            "ms_warm": {k: v["ms_warm"] for k, v in timing.items()},
            "same_bytes_ms": {k: v["same_bytes_ms"] for k, v in timing.items()
                              if "same_bytes_ms" in v}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

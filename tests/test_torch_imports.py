"""Import hygiene of the PyTorch port: it never imports jax or anything of
the JAX package, and neither does chip_smoke.py."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import code_intelligence_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # its imports only: main() runs under __main__
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "flax" or m.startswith("flax.")
             or m == "optax" or m.startswith("optax.")
             or m == "code_intelligence_tpu"
             or m.startswith("code_intelligence_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(REPO),
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    # the walk really covered the slice's modules
    for mod in ("ops.fused_lstm", "ops._build", "ops.quantize",
                "inference.slots", "inference.ragged_check",
                "inference.int8_check", "serving.server",
                "training.checkpoint", "text.tokenizer", "training.loop",
                "training.cli", "training.schedules", "training.callbacks",
                "data.corpus", "data.lm_loader"):
        assert f"code_intelligence_tpu_torch.{mod}" in out["modules"]


def test_kernel_source_ships_with_the_package():
    src = REPO / "code_intelligence_tpu_torch" / "csrc" / "fused_lstm.cu"
    text = src.read_text()
    # the recurrent product is the kernel's own loop, not a library call
    assert "lstm_step" in text and "lstm_bwd_step" in text
    assert "fmaf" in text
    for entry in ("fused_lstm_forward", "fused_lstm_forward_ragged",
                  "fused_lstm_forward_ragged_int8",  # K1, K2, K3
                  "fused_lstm_forward_gates", "fused_lstm_backward"):  # K4, K5
        assert f"int {entry}(" in text
    for lib in ("cublas", "cutlass", "cudnn"):
        assert lib not in text.lower()

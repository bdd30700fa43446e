"""PyTorch/CUDA port of ``code_intelligence_tpu``.

The package serves the same pooled issue embeddings as the JAX package,
from the same export directory (``encoder_params.npz``,
``model_config.json``, ``vocab.json``), on one NVIDIA GPU. Its layout
mirrors the JAX package's (``text/``, ``models/``, ``ops/``,
``inference/``, ``serving/``, ``utils/``) so each module's counterpart is
easy to find; the two packages share no code.

Hand-written CUDA kernels live in ``csrc/`` and are built with ``nvcc`` at
first use (``ops/_build.py``). Every entry point runs on ``cuda`` unless
the caller passes ``device="cpu"``; on the CPU each kernel wrapper runs
its plain PyTorch version.
"""

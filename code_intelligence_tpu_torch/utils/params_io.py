"""Flat ``.npz`` parameter files, read with numpy alone.

The JAX package stores a parameter tree as a flat npz keyed by
``'/'.join(path)``; this reads it back into the same nested dict, with
numpy arrays as leaves.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def load_params_npz(path) -> dict:
    params: dict = {}
    with np.load(Path(path)) as npz:
        for key in npz.files:
            node = params
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = npz[key]
    return params

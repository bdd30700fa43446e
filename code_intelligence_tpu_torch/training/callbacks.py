"""Training callbacks: the port's copy of the JAX package's
``training/callbacks.py``.

* callbacks are host-side and epoch/step-granular;
* ``on_step_end`` may return ``"stop"`` to end the fit;
* ``on_epoch_end`` may return ``"stop"`` (early stop) or
  ``("lr_scale", factor)`` (plateau LR cut), which the trainer applies to
  the state's ``lr_scale``;
* ``JSONLLogger`` writes the metrics stream any tracker can tail.
"""

from __future__ import annotations

import csv
import json
import math
import time
from pathlib import Path
from typing import Any, Dict, List, Optional


class Callback:
    def on_train_begin(self, trainer) -> None: ...

    def on_step_end(self, step: int, metrics: Dict[str, Any]):
        """May return ``"stop"`` to end the fit; anything else (None)
        continues. Step metrics are host floats: the window's loss, ce,
        accuracy, grad_norm, param_norm and lr, and step_time_s and
        tokens_per_sec."""
        return None

    def on_epoch_end(self, epoch: int, metrics: Dict[str, float], state, trainer):
        return None

    def on_train_end(self, history: List[Dict[str, float]]) -> None: ...


class History(Callback):
    def __init__(self):
        self.epochs: List[Dict[str, float]] = []

    def on_epoch_end(self, epoch, metrics, state, trainer):
        self.epochs.append(dict(metrics))


class EarlyStopping(Callback):
    """Stop when ``monitor`` hasn't improved for ``patience`` epochs
    (the reference's patience=2)."""

    def __init__(self, monitor: str = "val_loss", patience: int = 2, min_delta: float = 0.0):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.best = math.inf
        self.wait = 0

    def on_epoch_end(self, epoch, metrics, state, trainer):
        current = metrics.get(self.monitor)
        if current is None:
            return None
        if current < self.best - self.min_delta:
            self.best = current
            self.wait = 0
            return None
        self.wait += 1
        if self.wait > self.patience:
            return "stop"
        return None


class ReduceLROnPlateau(Callback):
    """Multiply the runtime LR scale by ``factor`` after ``patience``
    non-improving epochs (the reference's patience=1)."""

    def __init__(
        self,
        monitor: str = "val_loss",
        patience: int = 1,
        factor: float = 0.2,
        min_delta: float = 0.0,
    ):
        self.monitor = monitor
        self.patience = patience
        self.factor = factor
        self.min_delta = min_delta
        self.best = math.inf
        self.wait = 0

    def on_epoch_end(self, epoch, metrics, state, trainer):
        current = metrics.get(self.monitor)
        if current is None:
            return None
        if current < self.best - self.min_delta:
            self.best = current
            self.wait = 0
            return None
        self.wait += 1
        if self.wait > self.patience:
            self.wait = 0
            return ("lr_scale", self.factor)
        return None


class SaveBest(Callback):
    """Checkpoint the train state whenever ``monitor`` improves
    (fastai ``SaveModelCallback`` semantics)."""

    def __init__(self, ckpt_dir, monitor: str = "val_loss"):
        self.ckpt_dir = Path(ckpt_dir)
        self.monitor = monitor
        self.best = math.inf

    def on_epoch_end(self, epoch, metrics, state, trainer):
        current = metrics.get(self.monitor, metrics.get("loss"))
        if current is not None and current < self.best:
            self.best = current
            from code_intelligence_tpu_torch.training import checkpoint

            checkpoint.save_checkpoint(self.ckpt_dir, state)
        return None


class CSVLogger(Callback):
    """Per-epoch CSV, fastai ``CSVLogger`` equivalent."""

    def __init__(self, path):
        self.path = Path(path)
        self._rows: List[Dict[str, float]] = []

    def on_epoch_end(self, epoch, metrics, state, trainer):
        self._rows.append(dict(metrics))
        keys: List[str] = []
        for r in self._rows:
            for k in r:
                if k not in keys:
                    keys.append(k)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self.path.open("w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(self._rows)


class JSONLLogger(Callback):
    """Step metrics every ``every`` steps + epoch records, as JSON lines."""

    def __init__(self, path, every: int = 100):
        self.path = Path(path)
        self.every = every
        self._fh = None

    def on_train_begin(self, trainer) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = self.path.open("a")

    def _write(self, rec: Dict[str, Any]) -> None:
        if self._fh is None:
            return
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def on_step_end(self, step, metrics):
        if step % self.every == 0:
            self._write(
                {"kind": "step", "step": step, "ts": time.time()}
                | {k: float(v) for k, v in metrics.items()}
            )

    def on_epoch_end(self, epoch, metrics, state, trainer):
        # 'ts' = wall clock; the epoch metrics' own 'time' key is duration.
        self._write({"kind": "epoch", "ts": time.time()} | {k: float(v) for k, v in metrics.items()})

    def on_train_end(self, history):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

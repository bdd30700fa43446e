"""LM training loop for one card.

The port's copy of the JAX package's ``training/loop.py`` (``TrainConfig``,
``LMTrainer``), with the same numbers per window:

* loss = cross-entropy + AR (``alpha`` on the dropped output) + TAR
  (``beta`` on the raw output's time differences);
* AdamW as ``optax.inject_hyperparams(optax.adamw)`` computes it: ``b1``
  cycled by the momentum schedule, ``b2=0.99``, ``eps``, bias correction
  at the current ``b1``, and weight decay added to the Adam direction
  before the LR scales it; optional global-norm clipping first, and the
  runtime ``lr_scale`` (ReduceLROnPlateau) on the final update;
* truncated BPTT: the carried ``(h, c)`` of every layer is detached
  between windows;
* every dropout mask drawn once per window from the state's
  ``torch.Generator``.

PyTorch runs eagerly, so there is no compiled step: a window is one
forward and backward (K4 and K5 on the card) and one optimizer update.
``steps_per_dispatch`` keeps its meaning as the number of windows between
two host reads of the metrics. The parameters, the optimizer moments and
the generator are updated in place; a ``TrainState`` holds them.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from code_intelligence_tpu_torch.models import (
    AWDLSTMConfig,
    AWDLSTMLM,
    draw_dropout_masks,
    init_lstm_states,
    random_encoder_arrays,
)
from code_intelligence_tpu_torch.training import schedules
from code_intelligence_tpu_torch.training.checkpoint import params_from_numpy
from code_intelligence_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization hyperparameters, the JAX package's defaults."""

    batch_size: int = 104
    bptt: int = 67
    lr: float = 1.3e-3
    one_cycle: bool = True
    cycle_len: int = 1  # epochs per cycle
    moms: Tuple[float, float] = (0.85, 0.95)
    wd: float = 0.01
    alpha: float = 2.0  # AR on the dropped output
    beta: float = 1.0  # TAR on the raw output
    grad_clip: Optional[float] = None
    pct_start: float = 0.3
    adam_eps: float = 1e-7
    # windows between two host reads of the metrics
    steps_per_dispatch: int = 20


ADAM_B2 = 0.99  # fastai's Adam betas: (b1 cycled, 0.99)


@dataclasses.dataclass
class TrainState:
    """What a run carries from window to window. ``model`` holds the f32
    master parameters; ``opt_state`` the Adam moments ``mu`` and ``nu`` by
    parameter name; ``step`` counts optimizer updates."""

    step: int
    model: AWDLSTMLM
    opt_state: Dict[str, Dict[str, torch.Tensor]]
    lstm_states: tuple
    generator: torch.Generator
    lr_scale: float = 1.0


def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class LMTrainer:
    """Trains an AWD-LSTM LM on one device (``cuda`` unless asked)."""

    def __init__(self, model_config: AWDLSTMConfig,
                 train_config: TrainConfig = TrainConfig(),
                 steps_per_epoch: Optional[int] = None, device="cuda"):
        self.mcfg = model_config
        self.tcfg = train_config
        self.device = resolve_device(device)
        total = (steps_per_epoch or 1000) * train_config.cycle_len
        t = train_config
        if t.one_cycle:
            # fit_one_cycle(cyc_len, max_lr=lr*2)
            self.lr_schedule = schedules.one_cycle_lr(
                total, t.lr * 2, pct_start=t.pct_start)
            self.mom_schedule = schedules.one_cycle_momentum(
                total, *t.moms, pct_start=t.pct_start)
        else:
            self.lr_schedule = schedules.constant(t.lr)
            self.mom_schedule = schedules.constant(t.moms[1])

    # ------------------------------------------------------------------
    # State
    # ------------------------------------------------------------------

    def init_state(self, seed: int = 0,
                   batch_size: Optional[int] = None) -> TrainState:
        """Fresh parameters from a numpy seed (the JAX package's init
        ranges; ``decoder_b`` zeros), zero moments and carry, and the
        dropout generator seeded with ``seed``."""
        model = AWDLSTMLM(self.mcfg, device=self.device)
        model.encoder.load_state_dict(
            params_from_numpy(random_encoder_arrays(self.mcfg, seed)))
        opt_state = {n: {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}
                     for n, p in model.named_parameters()}
        return TrainState(
            step=0, model=model, opt_state=opt_state,
            lstm_states=init_lstm_states(
                self.mcfg, batch_size or self.tcfg.batch_size, self.device),
            generator=torch.Generator(device=self.device).manual_seed(seed))

    def reset_lstm_states(self, state: TrainState) -> TrainState:
        """Zero the carried hidden state (between epochs)."""
        state.lstm_states = tuple((torch.zeros_like(h), torch.zeros_like(c))
                                  for h, c in state.lstm_states)
        return state

    # ------------------------------------------------------------------
    # One window
    # ------------------------------------------------------------------

    def loss(self, model: AWDLSTMLM, x: torch.Tensor, y: torch.Tensor,
             lstm_states, masks: Optional[dict] = None):
        """``(loss, (new_states, ce, accuracy))`` of one window, the JAX
        ``LMTrainer._loss``."""
        logits, raw, dropped, new_states = model(x, lstm_states, masks)
        ce = F.cross_entropy(logits.float().flatten(0, 1), y.flatten())
        ar = self.tcfg.alpha * dropped.float().square().mean()
        tar = self.tcfg.beta * (raw[:, 1:] - raw[:, :-1]).float() \
            .square().mean()
        acc = (logits.argmax(-1) == y).float().mean()
        return ce + ar + tar, (new_states, ce, acc)

    def _tokens(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=self.device)

    def train_step(self, state: TrainState, x, y
                   ) -> Tuple[TrainState, Dict[str, object]]:
        """One window: forward, backward, AdamW. The metrics stay on the
        device (``lr`` is a host float), so the caller chooses when to
        read them."""
        x, y = self._tokens(x), self._tokens(y)
        model = state.model
        masks = draw_dropout_masks(self.mcfg, x.shape[0], state.generator,
                                   self.device)
        model.zero_grad(set_to_none=True)
        loss, (new_states, ce, acc) = self.loss(model, x, y,
                                                state.lstm_states, masks)
        loss.backward()
        grad_norm, param_norm, lr = self._adamw(state)
        state.lstm_states = tuple((h.detach(), c.detach())
                                  for h, c in new_states)
        state.step += 1
        return state, {"loss": loss.detach(), "ce": ce.detach(),
                       "accuracy": acc, "grad_norm": grad_norm,
                       "param_norm": param_norm, "lr": lr}

    @torch.no_grad()
    def _adamw(self, state: TrainState):
        """The optimizer update in place; returns ``(grad_norm,
        param_norm, lr)``, the norms on the device."""
        t = self.tcfg
        params = dict(state.model.named_parameters())
        grads = {n: p.grad for n, p in params.items()}
        grad_norm = _global_norm(grads.values())
        if t.grad_clip:
            clip = t.grad_clip
            grads = {n: torch.where(grad_norm < clip, g, g / grad_norm * clip)
                     for n, g in grads.items()}
        lr = self.lr_schedule(state.step)
        b1 = self.mom_schedule(state.step)
        count = state.step + 1
        bc1, bc2 = 1 - b1 ** count, 1 - ADAM_B2 ** count
        scale = -lr * state.lr_scale
        for n, p in params.items():
            g, m = grads[n], state.opt_state[n]
            m["mu"].mul_(b1).add_((1 - b1) * g)
            m["nu"].mul_(ADAM_B2).add_((1 - ADAM_B2) * g.square())
            update = (m["mu"] / bc1) / ((m["nu"] / bc2).sqrt() + t.adam_eps)
            p.add_((update + t.wd * p) * scale)
        return grad_norm, _global_norm(params.values()), lr * state.lr_scale

    def train_steps(self, state: TrainState, xs, ys
                    ) -> Tuple[TrainState, List[Dict[str, float]]]:
        """``len(xs)`` windows, then one host read of all their metrics."""
        device_metrics = []
        for x, y in zip(xs, ys):
            state, m = self.train_step(state, x, y)
            device_metrics.append(m)
        keys = [k for k in device_metrics[0] if k != "lr"]
        values = torch.stack([torch.stack([m[k].float() for k in keys])
                              for m in device_metrics]).tolist()
        return state, [dict(zip(keys, v), lr=m["lr"])
                       for v, m in zip(values, device_metrics)]

    # ------------------------------------------------------------------
    # Evaluate and fit
    # ------------------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, state: TrainState, valid_loader) -> Dict[str, float]:
        """Cross-entropy and accuracy over the loader, no dropout, from a
        zero carry sized to the loader's batch (K1 on the card)."""
        states = init_lstm_states(self.mcfg, valid_loader.local_bs,
                                  self.device)
        results = []
        for x, y in valid_loader.epoch(0):
            x, y = self._tokens(x), self._tokens(y)
            logits, _, _, states = state.model(x, states)
            results.append(torch.stack([
                F.cross_entropy(logits.float().flatten(0, 1), y.flatten()),
                (logits.argmax(-1) == y).float().mean()]))
        if not results:
            nan = float("nan")
            return {"val_loss": nan, "val_accuracy": nan,
                    "val_perplexity": nan}
        ce, acc = torch.stack(results).double().mean(0).tolist()
        return {"val_loss": ce, "val_accuracy": acc,
                "val_perplexity": math.exp(ce)}

    def fit(self, train_loader, valid_loader=None,
            epochs: Optional[int] = None, callbacks: Sequence = (),
            state: Optional[TrainState] = None, seed: int = 0
            ) -> Tuple[TrainState, List[Dict[str, float]]]:
        """Epochs of truncated BPTT over ``train_loader``, ``k =
        steps_per_dispatch`` windows per host read; then ``evaluate`` on
        ``valid_loader`` and the callbacks' epoch hooks, which may return
        ``"stop"`` or ``("lr_scale", factor)``. A step hook returning
        ``"stop"`` ends the fit after the current group of windows."""
        epochs = epochs if epochs is not None else self.tcfg.cycle_len
        if state is None:
            state = self.init_state(seed, batch_size=train_loader.local_bs)
        for cb in callbacks:
            cb.on_train_begin(self)
        history: List[Dict[str, float]] = []
        k = max(1, self.tcfg.steps_per_dispatch)
        tokens_per_window = train_loader.local_bs * self.tcfg.bptt
        for epoch in range(epochs):
            state = self.reset_lstm_states(state)
            t0 = time.time()
            losses: List[float] = []
            buf: List[tuple] = []
            halt = False

            def flush(state):
                t = time.perf_counter()
                state, metrics = self.train_steps(
                    state, [x for x, _ in buf], [y for _, y in buf])
                per_window = (time.perf_counter() - t) / len(buf)
                buf.clear()
                stop = False
                for m in metrics:
                    m.update(step_time_s=per_window,
                             tokens_per_sec=tokens_per_window / per_window)
                    losses.append(m["loss"])
                    for cb in callbacks:
                        stop |= cb.on_step_end(state.step, m) == "stop"
                return state, stop

            for x, y in train_loader.epoch(epoch):
                buf.append((x, y))
                if len(buf) == k:
                    state, halt = flush(state)
                    if halt:
                        break
            if buf and not halt:
                state, halt = flush(state)
            elapsed = time.time() - t0
            epoch_metrics = {
                "epoch": epoch,
                "loss": float(np.mean(losses)) if losses else float("nan"),
                "time": elapsed,
                "tokens_per_sec": len(losses) * tokens_per_window
                / max(elapsed, 1e-9),
            }
            if valid_loader is not None:
                epoch_metrics.update(self.evaluate(state, valid_loader))
            history.append(epoch_metrics)
            stop = halt
            for cb in callbacks:
                action = cb.on_epoch_end(epoch, epoch_metrics, state, self)
                if action == "stop":
                    stop = True
                elif isinstance(action, tuple) and action[0] == "lr_scale":
                    state.lr_scale *= action[1]
            if stop:
                break
        for cb in callbacks:
            cb.on_train_end(history)
        return state, history

"""Learning-rate and momentum schedules, as plain functions of the step.

The port's copy of the JAX package's ``training/schedules.py``: the same
values as its optax schedules (``one_cycle_lr`` is
``optax.cosine_onecycle_schedule`` with the same NaN-safe horizon), as
Python floats. The reference trains with fastai's
``fit_one_cycle(cyc_len, max_lr=lr*2)``: a cosine one-cycle over the LR
and an inverse momentum cycle (0.95 -> 0.85 -> 0.95).
"""

from __future__ import annotations

import logging
import math
from typing import Callable

log = logging.getLogger(__name__)

Schedule = Callable[[int], float]


def _cosine(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)


def one_cycle_lr(total_steps: int, lr_max: float, pct_start: float = 0.3,
                 div_factor: float = 25.0,
                 final_div_factor: float = 1e4) -> Schedule:
    """Cosine warmup ``lr_max/div_factor -> lr_max`` over ``pct_start`` of
    training, then cosine anneal to ``lr_max/div_factor/final_div_factor``.

    The horizon is at least ``ceil(1/pct_start)`` steps, so the warmup
    boundary is never step 0 (optax's schedule is NaN there); a shorter
    run is warned about, as it ends mid-cycle at an elevated LR."""
    safe_min = math.ceil(1.0 / max(pct_start, 1e-6))
    if safe_min > total_steps:
        log.warning(
            "one_cycle_lr: total_steps=%d is below the NaN-safe horizon "
            "%d for pct_start=%g; the schedule is stretched and training "
            "will end mid-cycle at an elevated LR",
            total_steps, safe_min, pct_start)
    n = max(safe_min, total_steps)
    bounds = (0, int(pct_start * n), int(n))
    values = (lr_max / div_factor, lr_max,
              lr_max / div_factor / final_div_factor)

    def schedule(step: int) -> float:
        for k in range(2):
            if bounds[k] <= step < bounds[k + 1]:
                pct = (step - bounds[k]) / (bounds[k + 1] - bounds[k])
                return _cosine(values[k], values[k + 1], pct)
        return values[2]

    return schedule


def one_cycle_momentum(total_steps: int, mom_min: float = 0.85,
                       mom_max: float = 0.95,
                       pct_start: float = 0.3) -> Schedule:
    """fastai's momentum cycle, mirrored against the LR cycle: high -> low
    during warmup, low -> high during anneal."""
    total_steps = max(1, total_steps)
    split = pct_start * total_steps

    def schedule(step: int) -> float:
        if step < split:
            frac = min(max(step / split, 0.0), 1.0)
            return mom_max + (mom_min - mom_max) * 0.5 * (
                1 - math.cos(math.pi * frac))
        frac = min(max((step - split) / max(total_steps - split, 1e-8),
                       0.0), 1.0)
        return mom_min + (mom_max - mom_min) * 0.5 * (
            1 - math.cos(math.pi * frac))

    return schedule


def constant(value: float) -> Schedule:
    return lambda step: value

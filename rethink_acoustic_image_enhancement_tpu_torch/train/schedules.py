"""Learning-rate schedules as plain functions of the step
(Train/basicsr/models/lr_scheduler.py).

Every shipped config uses ``CosineAnnealingRestartCyclicLR`` with a
per-period eta_min (KDLAET.yml:95-99, KDLAES.yml:87-91), optionally under a
linear warmup (base_model.py:183-205: while warming up the rate ramps
linearly to the *initial* rate, overriding the scheduler). The trainer sets
each parameter group's rate to ``schedule(step)`` before the step, the
update count starting at 0, as optax evaluates it. Unknown names fail when
the schedule is built.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, Sequence

import numpy as np

Schedule = Callable[[int], float]


def cosine_annealing_restart_cyclic(
    base_lr: float,
    periods: Sequence[int],
    restart_weights: Sequence[float] = (1,),
    eta_mins: Sequence[float] = (0,),
) -> Schedule:
    """lr_scheduler.py:186-233. A step on a period's boundary belongs to the
    earlier period (get_position_from_periods)."""
    assert len(periods) == len(restart_weights) == len(eta_mins)
    cumulative = [int(c) for c in np.cumsum(periods)]
    starts = [0] + cumulative[:-1]

    def schedule(step):
        i = min(bisect.bisect_left(cumulative, step), len(periods) - 1)
        frac = (step - starts[i]) / periods[i]
        eta = eta_mins[i]
        return eta + restart_weights[i] * 0.5 * (base_lr - eta) * (
            1 + math.cos(math.pi * frac))

    return schedule


def cosine_annealing_restart(
    base_lr: float,
    periods: Sequence[int],
    restart_weights: Sequence[float] = (1,),
    eta_min: float = 0.0,
) -> Schedule:
    """lr_scheduler.py:136-184 (one eta_min)."""
    return cosine_annealing_restart_cyclic(
        base_lr, periods, restart_weights, [eta_min] * len(periods))


def multi_step_restart(
    base_lr: float,
    milestones: Sequence[int],
    gamma: float = 0.1,
    restarts: Sequence[int] = (0,),
    restart_weights: Sequence[float] = (1,),
) -> Schedule:
    """lr_scheduler.py:7-47 in closed form: base * the weight of the last
    restart * gamma ** (milestones passed since that restart)."""
    ms = sorted(milestones)
    restarts = list(restarts)

    def schedule(step):
        r = min(max(sum(step >= s for s in restarts) - 1, 0), len(restarts) - 1)
        start = restarts[r]
        n = sum(start < m <= step for m in ms)
        return base_lr * restart_weights[r] * gamma ** n

    return schedule


def linear_lr(base_lr: float, total_iter: int) -> Schedule:
    """lr_scheduler.py:49-70."""
    return lambda step: base_lr * (1 - step / total_iter)


def vibrate_lr(base_lr: float, total_iter: int) -> Schedule:
    """lr_scheduler.py:72-134: a decaying triangular oscillation."""
    T = max(total_iter // 80, 1)
    Th = max(T // 2, 1)

    def schedule(step):
        process = step / total_iter
        f = (1 - process * 8 / 3 if process < 3 / 8
             else 0.2 if process < 5 / 8 else 0.1)
        t = step % T
        f2 = t / Th
        if t >= Th:
            f2 = 2 - f2
        weight = f * f2
        if step < Th:
            weight = max(weight, 0.1)
        return base_lr * weight

    return schedule


def cosine_annealing(base_lr: float, t_max: int, eta_min: float = 0.0) -> Schedule:
    """TrueCosineAnnealingLR / CosineAnnealingLR, in closed form."""
    return lambda step: eta_min + 0.5 * (base_lr - eta_min) * (
        1 + math.cos(math.pi * step / t_max))


def with_warmup(schedule: Schedule, base_lr: float, warmup_iter: int) -> Schedule:
    """Linear warmup (base_model.py:183-205): base_lr * step / warmup_iter
    while step < warmup_iter."""
    if warmup_iter is None or warmup_iter <= 0:
        return schedule
    return lambda step: (base_lr * step / warmup_iter if step < warmup_iter
                         else schedule(step))


SCHEDULERS = ("CosineAnnealingRestartCyclicLR", "CosineAnnealingRestartLR",
              "MultiStepLR", "MultiStepRestartLR", "LinearLR", "VibrateLR",
              "TrueCosineAnnealingLR", "CosineAnnealingLR")


def build_schedule(base_lr: float, scheduler_opt: dict,
                   warmup_iter: int = -1) -> Schedule:
    """From a reference-style ``train.scheduler`` dict."""
    opt = dict(scheduler_opt)
    kind = opt.pop("type")
    if kind == "CosineAnnealingRestartCyclicLR":
        s = cosine_annealing_restart_cyclic(
            base_lr, opt["periods"], opt.get("restart_weights", (1,)),
            opt.get("eta_mins", (0,)))
    elif kind == "CosineAnnealingRestartLR":
        s = cosine_annealing_restart(
            base_lr, opt["periods"], opt.get("restart_weights", (1,)),
            opt.get("eta_min", 0.0))
    elif kind in ("MultiStepLR", "MultiStepRestartLR"):
        s = multi_step_restart(
            base_lr, opt["milestones"], opt.get("gamma", 0.1),
            opt.get("restarts", (0,)), opt.get("restart_weights", (1,)))
    elif kind == "LinearLR":
        s = linear_lr(base_lr, opt["total_iter"])
    elif kind == "VibrateLR":
        s = vibrate_lr(base_lr, opt["total_iter"])
    elif kind in ("TrueCosineAnnealingLR", "CosineAnnealingLR"):
        s = cosine_annealing(base_lr, opt.get("T_max", opt.get("total_iter")),
                             opt.get("eta_min", 0.0))
    else:
        raise KeyError(f"unknown scheduler type {kind!r}")
    return with_warmup(s, base_lr, warmup_iter)

"""Learning-rate schedules as plain functions of the optimizer step
(counterpart of codeformer_tpu/train/schedulers.py; reference
basicsr/models/lr_scheduler.py and base_model.py:144-165).

The step is 0-based and counts optimizer updates, as the step optax's
`scale_by_learning_rate` sees: the trainer sets every param group's lr to
`schedule(step)` just before `optimizer.step()`.
"""
from __future__ import annotations

import bisect
import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def multi_step_lr(base_lr: float, milestones: Sequence[int],
                  gamma: float = 0.5) -> Schedule:
    """lr * gamma^(milestones passed): torch MultiStepLR (stage-II
    config)."""
    ms = sorted(milestones)

    def schedule(step: int) -> float:
        return base_lr * gamma ** bisect.bisect_right(ms, step)
    return schedule


def multi_step_restart_lr(base_lr: float, milestones: Sequence[int],
                          gamma: float = 0.5,
                          restarts: Sequence[int] = (0,),
                          restart_weights: Sequence[float] = (1,)
                          ) -> Schedule:
    """lr_scheduler.py:6-53: MultiStep with restarts; the weight of the
    latest restart at or before the step applies."""
    ms = sorted(milestones)

    def schedule(step: int) -> float:
        w = 1.0
        for r, rw in zip(restarts, restart_weights):
            if step >= r:
                w = rw
        return base_lr * w * gamma ** bisect.bisect_right(ms, step)
    return schedule


def cosine_annealing_restart_lr(base_lr: float, periods: Sequence[int],
                                restart_weights: Sequence[float] = (1,),
                                eta_min: float = 0.0) -> Schedule:
    """lr_scheduler.py:57-96: lr = eta_min + w * 0.5 * (base - eta_min) *
    (1 + cos(pi * t / T)), t the position inside the current period; past
    the last period, that period's final value."""
    if len(periods) != len(restart_weights):
        raise ValueError('periods and restart_weights differ in length')
    cum = [0]
    for p in periods:
        cum.append(cum[-1] + p)

    def value(i: int, t: float) -> float:
        return eta_min + restart_weights[i] * 0.5 * (base_lr - eta_min) * \
            (1 + math.cos(math.pi * t / periods[i]))

    def schedule(step: int) -> float:
        if step >= cum[-1]:
            return value(len(periods) - 1, periods[-1])
        i = bisect.bisect_right(cum, step) - 1
        return value(i, step - cum[i])
    return schedule


def with_warmup(schedule: Schedule, warmup_iter: int,
                base_lr: float) -> Schedule:
    """Linear warmup from 0 (base_model.py:144-165); warmup_iter <= 0 or
    None: off."""
    if warmup_iter is None or warmup_iter <= 0:
        return schedule

    def warmed(step: int) -> float:
        if step < warmup_iter:
            return base_lr * (step + 1) / warmup_iter
        return schedule(step)
    return warmed


def build_schedule(train_opt: dict, base_lr: float) -> Schedule:
    """From a YAML `scheduler:` block (options/*.yml)."""
    sched = dict(train_opt.get('scheduler') or {})
    stype = sched.pop('type', None)
    if stype is None:
        def fn(step: int) -> float:
            return base_lr
    elif stype == 'MultiStepLR':
        fn = multi_step_lr(base_lr, sched['milestones'],
                           sched.get('gamma', 0.1))
    elif stype == 'MultiStepRestartLR':
        fn = multi_step_restart_lr(
            base_lr, sched['milestones'], sched.get('gamma', 0.1),
            sched.get('restarts', (0,)), sched.get('restart_weights', (1,)))
    elif stype == 'CosineAnnealingRestartLR':
        fn = cosine_annealing_restart_lr(
            base_lr, sched['periods'], sched.get('restart_weights', (1,)),
            sched.get('eta_min', 0.0))
    else:
        raise NotImplementedError(f'scheduler {stype}')
    return with_warmup(fn, train_opt.get('warmup_iter', -1), base_lr)

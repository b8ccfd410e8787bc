"""Optimizer and learning-rate schedule from the training plan.

Counterpart of ``montecarlo_gated_mil_tpu/train/optim.py``: Adam or SGD with
``weight_decay`` as L2 added to the gradient before the optimizer statistics
(torch semantics, which is optax ``add_decayed_weights`` before the core
transform), and the ``none | step | cosine | lin`` schedules.  The schedule
is a ``LambdaLR`` stepped once per optimizer step over a base rate of 1, so
the rate of update ``s`` (0-based) is ``schedule(s)``: optax evaluates its
schedule at the update count *before* the increment, and ``LambdaLR`` has
taken ``s`` steps when the optimizer makes its update ``s``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from montecarlo_gated_mil_tpu_torch.core.config import TrainingPlan


def make_schedule(plan: TrainingPlan, steps_per_epoch: int = 1) -> Callable[[int], float]:
    """Learning rate of optimizer update ``s`` (0-based).

    With ``scheduler.unit == 'epoch'`` (the default, torch StepLR's unit)
    decay points are epochs of ``steps_per_epoch`` optimizer steps; with
    ``'step'`` they count optimizer steps.  Same formulas as optax's
    ``exponential_decay(staircase=True)``, ``cosine_decay_schedule`` and
    ``linear_schedule``.
    """
    base = plan.parameters.lr
    sched = plan.scheduler
    name = sched.name.lower()
    if name in ("none", ""):
        return lambda s: base
    if steps_per_epoch < 1:
        raise ValueError(f"steps_per_epoch must be >= 1, got {steps_per_epoch}")
    mult = steps_per_epoch if sched.unit.lower() == "epoch" else 1
    if name == "step":
        every = sched.step_size * mult
        if every <= 0:
            return lambda s: base
        return lambda s: base * sched.gamma ** (s // every)
    if name == "cosine":
        steps = max(sched.step_size, 1) * mult

        def cosine(s: int) -> float:
            return base * 0.5 * (1.0 + math.cos(math.pi * min(s, steps) / steps))

        return cosine
    if name == "lin":
        steps = max(sched.step_size, 1) * mult
        end = base * sched.gamma
        return lambda s: (base - end) * (1.0 - min(s, steps) / steps) + end
    raise ValueError(f"unknown scheduler {sched.name!r}")


def make_optimizer(
    plan: TrainingPlan, params, steps_per_epoch: int = 1
) -> tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """``(optimizer, scheduler)`` over ``params``; call ``scheduler.step()``
    after every ``optimizer.step()``."""
    wd = plan.parameters.wd
    name = plan.optimizer.lower()
    if name == "adam":
        opt = torch.optim.Adam(params, lr=1.0, weight_decay=wd)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=1.0, weight_decay=wd)
    else:
        raise ValueError(f"optimizer must be adam or sgd, got {plan.optimizer!r}")
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, make_schedule(plan, steps_per_epoch))

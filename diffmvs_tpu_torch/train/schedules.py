"""Learning-rate schedules matching the reference's two options.

Counterpart of diffmvs_tpu/train/schedules.py. Each schedule is a plain
function of the optimizer step that returns the learning rate the optax
schedule gives at that step; make_lr_lambda turns it into the factor
torch.optim.lr_scheduler.LambdaLR multiplies the base rate (cfg.lr) by.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def _linear(init_value: float, end_value: float, transition_steps: int):
    """optax.linear_schedule: init -> end over transition_steps, then end.
    Evaluated in float32 in optax's operation order: near its start,
    (init - end) * frac + end cancels, and float32 rounds it ~2e-6 away
    from the exact rate; this keeps the two packages' rates equal."""
    f32 = np.float32

    def schedule(count):
        if transition_steps <= 0:
            return init_value
        count = f32(min(max(count, 0), transition_steps))
        frac = f32(1.0) - count / f32(transition_steps)
        return float(f32(init_value - end_value) * frac + f32(end_value))
    return schedule


def onecycle_linear(total_steps: int, peak_lr: float, pct_start: float = 0.05,
                    div_factor: float = 25.0,
                    final_div_factor: float = 1e4) -> Callable[[int], float]:
    """torch OneCycleLR with linear annealing: warm from peak/div_factor to
    peak over pct_start, then anneal linearly to initial/final_div_factor.
    The reference sizes it to len(loader)*epochs + 100 steps."""
    init_lr = peak_lr / div_factor
    final_lr = init_lr / final_div_factor
    warm = max(1, int(total_steps * pct_start))
    up = _linear(init_lr, peak_lr, warm)
    down = _linear(peak_lr, final_lr, total_steps - warm)
    return lambda step: up(step) if step < warm else down(step - warm)


def multistep(steps_per_epoch: int, base_lr: float,
              lrepochs: str) -> Callable[[int], float]:
    """'e1,e2,e3:gamma_inv' -- divide lr by gamma_inv at those epochs."""
    epochs_part, gamma_part = lrepochs.split(":")
    boundaries = sorted(int(e) * steps_per_epoch
                        for e in epochs_part.split(","))
    gamma = 1.0 / float(gamma_part)

    def schedule(step):
        lr = base_lr
        for b in boundaries:
            if step >= b:
                lr = lr * gamma
        return lr
    return schedule


def make_lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """cfg: TrainConfig."""
    if cfg.lr_sche == "onecycle":
        return onecycle_linear(steps_per_epoch * cfg.epochs + 100, cfg.lr)
    if cfg.lr_sche == "mslr":
        return multistep(steps_per_epoch, cfg.lr, cfg.lrepochs)
    raise NotImplementedError(cfg.lr_sche)


def make_lr_lambda(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """The LambdaLR factor: schedule(step) / cfg.lr."""
    schedule = make_lr_schedule(cfg, steps_per_epoch)
    return lambda step: schedule(step) / cfg.lr

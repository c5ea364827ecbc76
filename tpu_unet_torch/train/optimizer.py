"""Optimizer and LR scheduling (counterpart of ``tpu_unet/train/optimizer.py``).

* SGD with momentum: ``torch.optim.SGD(lr, momentum=0.99)``, dampening 0,
  no Nesterov: buf = mu * buf + grad; p -= lr * buf, the same update as the
  JAX package's optax trace.
* ReduceLROnPlateau as a pure function (state in, state out), so it
  checkpoints and restores exactly; copied from the JAX package, whose
  module cannot be imported without optax.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Tuple

import torch

from tpu_unet_torch.config import OptimConfig


class PlateauState(NamedTuple):
    """Functional ReduceLROnPlateau (torch semantics, mode='min')."""

    lr: float
    best: float
    num_bad_epochs: int
    cooldown_counter: int


def plateau_init(cfg: OptimConfig) -> PlateauState:
    return PlateauState(lr=cfg.lr, best=float("inf"), num_bad_epochs=0,
                        cooldown_counter=0)


def _is_better(metric: float, best: float, cfg: OptimConfig) -> bool:
    if cfg.plateau_threshold_mode == "rel":
        return metric < best * (1.0 - cfg.plateau_threshold)
    return metric < best - cfg.plateau_threshold


def plateau_step(state: PlateauState, metric: float, cfg: OptimConfig,
                 cooldown: int = 0) -> Tuple[PlateauState, bool]:
    """One scheduler step on the epoch metric. Returns (new_state, reduced)."""
    lr = state.lr
    best = state.best
    num_bad = state.num_bad_epochs
    cd = state.cooldown_counter

    if _is_better(metric, best, cfg):
        best = metric
        num_bad = 0
    else:
        num_bad += 1

    if cd > 0:
        cd -= 1
        num_bad = 0

    reduced = False
    if num_bad > cfg.plateau_patience:
        new_lr = lr * cfg.plateau_factor
        if lr - new_lr > cfg.plateau_eps:
            lr = new_lr
            reduced = True
        cd = cooldown
        num_bad = 0

    return PlateauState(lr=lr, best=best, num_bad_epochs=num_bad,
                        cooldown_counter=cd), reduced


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: OptimConfig
                   ) -> torch.optim.SGD:
    """SGD with momentum over `params` at the configured learning rate."""
    return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every parameter group of `opt`."""
    for group in opt.param_groups:
        group["lr"] = lr

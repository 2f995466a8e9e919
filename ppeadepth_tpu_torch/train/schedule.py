"""Optimizer and learning-rate schedule (JAX counterpart:
train/schedule.py): Adam over the trainable parameters (trainer.py:141-144)
and StepLR (step_size 15 epochs, gamma 0.1) stepped per epoch
(trainer.py:144, 418), expressed per step: update i (from 0) takes
`base_lr * gamma ** ((i // steps_per_epoch) // step_size_epochs)`, as the
optax schedule does."""

from __future__ import annotations

import torch


def step_lr_factor(steps_per_epoch: int, step_size_epochs: int = 15,
                   gamma: float = 0.1):
    """Multiplier of the base learning rate at update `step`."""
    def factor(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return gamma ** (epoch // step_size_epochs)

    return factor


def make_optimizer(params, base_lr: float, steps_per_epoch: int,
                   step_size_epochs: int = 15, gamma: float = 0.1):
    """(torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8), its per-step
    LambdaLR) over `params`; the train step steps both once per update.
    Parameters that all lie on a card take torch's fused Adam (one kernel
    per group of tensors instead of a dozen elementwise passes)."""
    params = list(params)
    fused = bool(params) and all(p.is_cuda for p in params)
    opt = torch.optim.Adam(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                           fused=fused or None)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, step_lr_factor(steps_per_epoch, step_size_epochs, gamma))
    return opt, sched

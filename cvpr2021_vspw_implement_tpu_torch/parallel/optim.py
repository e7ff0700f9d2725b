"""Optimizer and LR schedule of the clip trainer (JAX counterpart:
parallel/optim.py ``poly_schedule`` and ``create_clip_optimizer``; reference
train_clip2.py:215-252).

One ``torch.optim.SGD`` over four parameter groups: the encoder at 0.1x LR
and the heads at 1x, each split into decayed parameters and biases, which
are not decayed (BatchNorm scales *do* decay in this recipe).  ``--fix``
freezes the encoder, and the frozen RAFT flow net never reaches the
optimizer.  torch's SGD with dampening 0 (``d = g + wd*p; v = mu*v + d;
p -= lr*v``) is the math of the JAX package's optax chain; the poly factor
``(1 - step/max_iters)**power`` is applied per step, counting from 0.
"""

from __future__ import annotations

import torch
from torch import nn


def poly_schedule(base_lr: float, max_iters: int, power: float = 0.9):
    def schedule(count: int) -> float:
        return base_lr * max(1.0 - count / max_iters, 0.0) ** power
    return schedule


def create_clip_optimizer(model: nn.Module, lr: float, max_iters: int,
                          momentum: float = 0.9, weight_decay: float = 1e-4,
                          lr_pow: float = 0.9, fix_encoder: bool = False):
    """→ (optimizer, scheduler); call ``scheduler.step()`` after every
    ``optimizer.step()``.  With ``fix_encoder`` the encoder's parameters stop
    requiring gradients."""
    groups: dict[tuple[float, float], list] = {}
    for name, p in model.named_parameters():
        if name.startswith("raft.") or ".raft." in name:
            continue
        in_encoder = name.startswith("encoder.")
        if in_encoder and fix_encoder:
            p.requires_grad_(False)
            continue
        key = (0.1 if in_encoder else 1.0,
               0.0 if name.endswith("bias") else weight_decay)
        groups.setdefault(key, []).append(p)
    optimizer = torch.optim.SGD(
        [{"params": ps, "lr": lr * mult, "weight_decay": wd}
         for (mult, wd), ps in groups.items()],
        lr=lr, momentum=momentum)
    factor = poly_schedule(1.0, max_iters, lr_pow)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
    return optimizer, scheduler

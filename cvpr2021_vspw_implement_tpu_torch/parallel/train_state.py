"""The train step of the clip trainer (JAX counterpart:
parallel/train_state.py ``make_train_step``; reference train_clip2.py:
26-126): forward, loss, backward, SGD update and schedule, with BatchNorm
running statistics updated by the forward.
"""

from __future__ import annotations

import torch


def to_device(batch: dict, device) -> dict:
    """A collated numpy batch (NHWC images) → tensors on ``device``:
    ``img`` [T, B, 3, H, W] float32, ``labels`` [T, B, H, W] int64."""
    img = torch.from_numpy(batch["img"]).to(device, non_blocking=True)
    labels = torch.from_numpy(batch["labels"]).to(device, non_blocking=True)
    return {"img": img.permute(0, 1, 4, 2, 3).contiguous(),
            "labels": labels.long()}


def train_step(model, optimizer, scheduler, batch, loss_fn) -> dict:
    """One step on ``batch`` (tensors on the model's device); ``loss_fn(outs,
    batch) -> (loss, acc)``.  Returns {"loss", "acc"} as 0-d tensors.
    Dropout masks come from the generator that
    ``models.layers.set_dropout_generator`` gave the model."""
    model.train()
    loss, acc = loss_fn(model(batch["img"]), batch)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    # a parameter the loss does not reach still decays, as in the optax chain
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    optimizer.step()
    scheduler.step()
    return {"loss": loss.detach(), "acc": acc.detach()}

"""Checkpoints of the trainer (JAX counterpart: utils/checkpoint.py, which
serialises the whole TrainState): one ``torch.save`` of the model's
``state_dict``, the optimizer's and the scheduler's state, the step and the
epoch, as ``<dir>/model_epoch_<epoch>.pth``.
"""

from __future__ import annotations

import os

import torch


def save_checkpoint(ckpt_dir: str, model, optimizer, scheduler, step: int,
                    epoch: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"model_epoch_{epoch}.pth")
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict(),
                "step": step, "epoch": epoch}, path)
    return path


def load_checkpoint(path: str, model, optimizer, scheduler) -> tuple[int, int]:
    """Restore in place; returns (step, epoch)."""
    ckpt = torch.load(path, map_location="cpu")
    model.load_state_dict(ckpt["model"])
    optimizer.load_state_dict(ckpt["optimizer"])
    scheduler.load_state_dict(ckpt["scheduler"])
    return ckpt["step"], ckpt["epoch"]

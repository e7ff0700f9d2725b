"""Bilinear and nearest resize of NCHW tensors (JAX counterpart:
ops/interpolate.py, which reproduces these ``F.interpolate`` semantics as
matmuls: half-pixel centres for ``align_corners=False``, no antialiasing,
legacy ``nearest``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = False):
    """[N, C, H, W] → [N, C, *size]."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=align_corners)


def resize_nearest(x: torch.Tensor, size):
    """[N, C, H, W] → [N, C, *size], legacy ``nearest`` (floor of i*in/out)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="nearest")

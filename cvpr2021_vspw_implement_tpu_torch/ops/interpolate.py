"""Bilinear and nearest resize of NCHW tensors (JAX counterpart:
ops/interpolate.py, which reproduces these ``F.interpolate`` semantics as
matmuls: half-pixel centres for ``align_corners=False``, no antialiasing,
legacy ``nearest``)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def linear_weights(in_size: int, out_size: int,
                   align_corners: bool = False) -> np.ndarray:
    """[out, in] row-stochastic matrix of torch's linear interpolation (a
    copy of the JAX package's ``_linear_weights``): for
    ``align_corners=False`` src = max(0, (dst + 0.5) * in/out - 0.5),
    x0 = floor(src), x1 = min(x0 + 1, in - 1), weight = src - x0."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        w[:, 0] = 1.0
        return w
    for i in range(out_size):
        if align_corners:
            src = i * (in_size - 1) / max(out_size - 1, 1)
        else:
            src = max(0.0, (i + 0.5) * in_size / out_size - 0.5)
        x0 = min(int(np.floor(src)), in_size - 1)
        x1 = min(x0 + 1, in_size - 1)
        lam = src - x0
        w[i, x0] += 1.0 - lam
        w[i, x1] += lam
    return w


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

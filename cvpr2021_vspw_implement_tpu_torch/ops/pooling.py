"""Pooling of NCHW tensors (JAX counterpart: ops/pooling.py, which builds
the torch adaptive bins as matmuls)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .masked import mask_current


def adaptive_avg_pool2d(x: torch.Tensor, output_size) -> torch.Tensor:
    return F.adaptive_avg_pool2d(x, output_size)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] → [N, C, 1, 1]."""
    return x.mean(dim=(2, 3), keepdim=True)


def max_pool_3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(3, stride 2, padding 1): the ResNet stem pool.

    Under a width-bucket mask context (ops/masked.py) the input's pad band
    is re-zeroed first, in place: the pool is spatial and no conv hook
    covers it.  Its input is post-ReLU (non-negative), so zeros in the band
    give the unpadded run's -inf edge padding exactly."""
    return F.max_pool2d(mask_current(x), 3, stride=2, padding=1)

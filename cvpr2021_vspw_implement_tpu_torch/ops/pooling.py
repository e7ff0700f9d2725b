"""Pooling of NCHW tensors (JAX counterpart: ops/pooling.py, which builds
the torch adaptive bins as matmuls)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def adaptive_avg_pool2d(x: torch.Tensor, output_size) -> torch.Tensor:
    return F.adaptive_avg_pool2d(x, output_size)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] → [N, C, 1, 1]."""
    return x.mean(dim=(2, 3), keepdim=True)


def max_pool_3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(3, stride 2, padding 1): the ResNet stem pool."""
    return F.max_pool2d(x, 3, stride=2, padding=1)

"""RAFT feature and context encoders (JAX counterpart:
models/raft/extractor.py; reference RAFT_core/extractor.py).

BasicEncoder: 7x7/2 stem, three 2-block residual stages (64, 96/2, 128/2)
and a 1x1 output conv.  ``norm_fn`` 'instance' (the feature net) is torch
``InstanceNorm2d(affine=False)``: per-sample, per-channel statistics over
H, W with the biased variance and eps 1e-5; 'batch' (the context net) runs
on running statistics, since the flow subsystem is frozen.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.masked import current_mask, feature_valid


class InstanceNorm2d(nn.InstanceNorm2d):
    """``nn.InstanceNorm2d(affine=False)``; under a width-bucket mask
    context (ops/masked.py) the statistics cover the valid region only, the
    one global reduction of the flow encoders that no conv-input mask
    fixes."""

    def forward(self, x):
        ctx = current_mask()
        if ctx is None:
            return super().forward(x)
        hv, wv = feature_valid(x.shape[-2], x.shape[-1], *ctx)
        v = x[..., :hv, :wv].float()
        mean = v.mean(dim=(-2, -1), keepdim=True)
        var = (v - mean).square().mean(dim=(-2, -1), keepdim=True)
        return ((x.float() - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


def _norm(norm_fn: str, planes: int) -> nn.Module:
    if norm_fn == "instance":
        return InstanceNorm2d(planes)
    if norm_fn == "batch":
        return nn.BatchNorm2d(planes)
    raise ValueError(f"norm_fn {norm_fn!r} is not ported")


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn="instance", stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.relu = nn.ReLU(inplace=True)
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            # reference layout: the shortcut norm is both norm3 and
            # downsample.1 (one module under two names)
            self.norm3 = _norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim=128, norm_fn="batch"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm_fn, 64)
        self.relu1 = nn.ReLU(inplace=True)
        dims = [(64, 1), (96, 2), (128, 2)]
        cin = 64
        for i, (dim, stride) in enumerate(dims):
            self.add_module(f"layer{i + 1}", nn.Sequential(
                ResidualBlock(cin, dim, norm_fn, stride),
                ResidualBlock(dim, dim, norm_fn, 1)))
            cin = dim
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = self.relu1(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)

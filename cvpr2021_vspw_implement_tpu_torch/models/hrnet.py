"""HRNetV2-W48 trunk (JAX counterpart: models/hrnet.py; reference
models/hrnet.py:104-446).

Four parallel branches at output strides 4, 8, 16 and 32 (48, 96, 192 and
384 channels), fused all to all after every module; the output is the
concat of the four upsampled to stride 4, one 720-channel map (``forward``
returns it as a one-item list, the reference's ``return_feature_maps``).
Stem: two 3x3 stride-2 convs, then ``layer1``, four ``Bottleneck(64)``
blocks.  Stages 2, 3 and 4 have 1, 4 and 3 modules of 2, 3 and 4 branches,
four ``BasicBlock``\\ s a branch.

Module names are the reference's, which the JAX package's
``import_hrnet_state_dict`` reads: ``conv1``, ``bn1``, ``conv2``, ``bn2``,
``layer1.N``; ``transition{1,2,3}.i`` (stage s's is ``transition{s-1}``;
an existing branch ``Sequential(conv, bn, relu)``, a new one
``Sequential(Sequential(conv, bn, relu))``, a branch that keeps its width
None); ``stage{2,3,4}.m.branches.i.b``; ``stage*.m.fuse_layers.i.j``:
``Sequential(conv1x1, bn)`` for j > i, (i - j) ``Sequential(conv3x3 s2,
bn[, relu])`` for j < i, the last without its ReLU, None for j = i.

Width-bucketed eval (``valid_hw`` / ``pad_hw`` at input resolution, under
``ops/masked.py::masked_trunk``): the spatial convs' inputs are re-zeroed
by the trunk's hooks; only the cross-resolution upsamples (the j > i fuses
and the final concat) need the true size, since a resize of the padded grid
samples positions of the padded size: they take ``resize_bilinear_rt`` with
each level's valid size (``feature_valid``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.interpolate import resize_bilinear
from ..ops.masked import feature_valid, resize_bilinear_rt
from .layers import BatchNorm2d, Conv
from .resnet import BasicBlock, Bottleneck

#: stage → (modules, branch widths) of W48 (reference hrnet.py:261-264)
STAGES = {2: (1, (48, 96)), 3: (4, (48, 96, 192)),
          4: (3, (48, 96, 192, 384))}
BLOCKS_PER_BRANCH = 4


def _conv_bn(cin: int, cout: int, stride: int = 1, kernel: int = 3,
             relu: bool = True) -> nn.Sequential:
    layers = [Conv(cin, cout, kernel, stride, 1 if kernel == 3 else 0,
                   bias=False), BatchNorm2d(cout)]
    if relu:
        layers.append(nn.ReLU(inplace=True))
    return nn.Sequential(*layers)


def _upsample(t, ref, valid_hw, pad_hw):
    """``t`` resized to the grid of ``ref``, the level it lands on:
    plainly, or on the padded grid with the true sizes of both."""
    size = ref.shape[-2:]
    if valid_hw is None:
        return resize_bilinear(t, size)
    return resize_bilinear_rt(
        t, size, feature_valid(*t.shape[-2:], valid_hw, pad_hw),
        feature_valid(*size, valid_hw, pad_hw))


class HighResolutionModule(nn.Module):
    """Parallel branches, then every branch fused into every other
    (reference hrnet.py:104-251)."""

    def __init__(self, channels):
        super().__init__()
        self.channels = tuple(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(c, c)
                            for _ in range(BLOCKS_PER_BRANCH)))
            for c in channels)
        fuse = []
        for i, ci in enumerate(channels):
            row = []
            for j, cj in enumerate(channels):
                if j > i:
                    row.append(_conv_bn(cj, ci, kernel=1, relu=False))
                elif j == i:
                    row.append(None)
                else:
                    row.append(nn.Sequential(*(
                        _conv_bn(cj, ci if k == i - j - 1 else cj, stride=2,
                                 relu=k != i - j - 1)
                        for k in range(i - j))))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, xs, valid_hw=None, pad_hw=None):
        outs = [branch(x) for branch, x in zip(self.branches, xs)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, layer in enumerate(row):
                if j == i:
                    t = outs[j]
                elif j > i:
                    t = _upsample(layer(outs[j]), outs[i], valid_hw, pad_hw)
                else:
                    t = layer(outs[j])
                # out of place: outs[j] feeds the other rows too, and
                # with two or more branches y ends as a new tensor
                y = t if y is None else y + t
            fused.append(self.relu(y))
        return fused


class HRNetV2(nn.Module):
    """The HRNetV2-W48 trunk: [N, 3, H, W] → [the 720-channel map at output
    stride 4]."""

    #: width-bucketed eval gives it the true and padded sizes
    #: (ops/masked.py::masked_encode)
    resizes_across_levels = True

    def __init__(self):
        super().__init__()
        self.conv1 = Conv(3, 64, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = Conv(64, 64, 3, 2, 1, bias=False)
        self.bn2 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.layer1 = nn.Sequential(*(
            Bottleneck(64 if b == 0 else 256, 64, downsample=nn.Sequential(
                Conv(64, 256, 1, bias=False), BatchNorm2d(256))
                if b == 0 else None)
            for b in range(4)))
        prev = (256,)
        for stage, (modules, chans) in STAGES.items():
            trans = []
            for i, c in enumerate(chans):
                if i < len(prev):
                    trans.append(_conv_bn(prev[i], c) if prev[i] != c
                                 else None)
                else:
                    trans.append(nn.Sequential(_conv_bn(prev[-1], c,
                                                        stride=2)))
            self.add_module(f"transition{stage - 1}", nn.ModuleList(trans))
            self.add_module(f"stage{stage}", nn.Sequential(*(
                HighResolutionModule(chans) for _ in range(modules))))
            prev = chans

    def stem(self, x):
        """The two stride-2 convs and ``layer1``: [N, 256, H/4, W/4]."""
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        return self.layer1(x)

    def stages(self, x, valid_hw=None, pad_hw=None):
        """Transitions, stages 2-4 and the concat at stride 4 of the stem's
        output ``x``; ``valid_hw`` / ``pad_hw``: the input-resolution true
        and padded sizes in width-bucketed eval."""
        xs = [x]
        for stage in STAGES:
            trans = getattr(self, f"transition{stage - 1}")
            # a new branch comes from the previous stage's last one
            xs = [xs[i] if t is None else t(xs[min(i, len(xs) - 1)])
                  for i, t in enumerate(trans)]
            for module in getattr(self, f"stage{stage}"):
                xs = module(xs, valid_hw, pad_hw)
        return torch.cat([xs[0]] + [_upsample(b, xs[0], valid_hw, pad_hw)
                                    for b in xs[1:]], 1)

    def forward(self, x, valid_hw=None, pad_hw=None):
        if valid_hw is not None and pad_hw is None:
            pad_hw = x.shape[-2:]
        return [self.stages(self.stem(x), valid_hw, pad_hw)]

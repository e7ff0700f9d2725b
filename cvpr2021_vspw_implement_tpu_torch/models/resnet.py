"""Deep-stem dilated ResNet trunks (JAX counterpart: models/resnet.py).

Deep stem of three 3x3 convs (64, 64, 128) and a 3x3/2 max pool; output
stride 8 (``dilate_scale=8``): stages 3 and 4 keep stride 1, their first
block's 3x3 conv takes dilation d/2 and every other 3x3 conv dilation d
(d = 2, 4) — ``ResnetDilated._nostride_dilate`` (reference
models/models.py:737-750).
``forward`` returns the [C2, C3, C4, C5] maps.
"""

from __future__ import annotations

from torch import nn

from ..ops.pooling import max_pool_3x3_s2_p1
from .layers import BatchNorm2d, Conv


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 first_dilation=None, downsample=None):
        super().__init__()
        fd = first_dilation or dilation
        self.conv1 = Conv(inplanes, planes, 3, stride, fd, fd, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv(planes, planes, 3, 1, dilation, dilation,
                          bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return self.relu(out + res)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 first_dilation=None, downsample=None):
        super().__init__()
        fd = first_dilation or dilation
        self.conv1 = Conv(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv(planes, planes, 3, stride, fd, fd, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return self.relu(out + res)


class ResNetFeatures(nn.Module):
    """Deep-stem dilated (output stride 8) ResNet trunk returning the
    [C2, C3, C4, C5] pyramid."""

    def __init__(self, block=Bottleneck, layers=(3, 4, 23, 3)):
        super().__init__()
        self.conv1 = Conv(3, 64, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = Conv(64, 64, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(64)
        self.conv3 = Conv(64, 128, 3, 1, 1, bias=False)
        self.bn3 = BatchNorm2d(128)
        self.relu = nn.ReLU(inplace=True)

        strides = (1, 2, 1, 1)
        dilations = (1, 1, 2, 4)
        first_dilations = (1, 1, 1, 2)

        inplanes = 128
        for stage, planes in enumerate((64, 128, 256, 512)):
            blocks = []
            out_planes = planes * block.expansion
            for b in range(layers[stage]):
                first = b == 0
                downsample = None
                if first and (strides[stage] != 1 or inplanes != out_planes):
                    downsample = nn.Sequential(
                        Conv(inplanes, out_planes, 1, strides[stage],
                             bias=False),
                        BatchNorm2d(out_planes))
                blocks.append(block(
                    inplanes, planes,
                    stride=strides[stage] if first else 1,
                    dilation=dilations[stage],
                    first_dilation=first_dilations[stage] if first else None,
                    downsample=downsample))
                inplanes = out_planes
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        x = self.relu(self.bn3(self.conv3(x)))
        x = max_pool_3x3_s2_p1(x)
        outs = []
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
            outs.append(x)
        return outs


def build_encoder(arch: str) -> ResNetFeatures:
    """The dilated ResNet trunks, by the reference arch name (the other
    encoders raise in ``models.builder.ModelBuilder.build_encoder``)."""
    archs = {
        "resnet18dilated": (BasicBlock, (2, 2, 2, 2)),
        "resnet50dilated": (Bottleneck, (3, 4, 6, 3)),
        "resnet101dilated": (Bottleneck, (3, 4, 23, 3)),
    }
    if arch.lower() not in archs:
        raise ValueError(f"encoder {arch!r} is not ported; one of "
                         f"{sorted(archs)}")
    block, layers = archs[arch.lower()]
    return ResNetFeatures(block, layers)

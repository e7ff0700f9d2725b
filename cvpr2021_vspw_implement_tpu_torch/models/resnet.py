"""Deep-stem ResNet and ResNeXt trunks (JAX counterpart: models/resnet.py;
reference models/resnet.py:95-207, models/resnext.py:23-154).

Deep stem of three 3x3 convs (64, 64, 128) and a 3x3/2 max pool, then
four stages; ``forward`` returns the [C2, C3, C4, C5] maps.  Output stride
32 by default; ``dilate_scale`` 8 is ``ResnetDilated._nostride_dilate``
(reference models/models.py:737-750): stages 3 and 4 keep stride 1, their
first block's 3x3 conv takes dilation d/2 and every other 3x3 conv
dilation d (d = 2, 4).  ResNeXt-101
is ``GroupBottleneck`` (a grouped 3x3, expansion 2) on doubled stage
widths.  Module names are the reference's (``conv1``, ``layer3.5.conv2``,
``layer1.0.downsample.0``), so a ``state_dict()`` reads back through the
JAX package's ``import_resnet_state_dict``.
"""

from __future__ import annotations

from torch import nn

from ..ops.pooling import max_pool_3x3_s2_p1
from .layers import BatchNorm2d, Conv


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 first_dilation=None, downsample=None, groups=1):
        super().__init__()
        if groups != 1:
            raise ValueError("BasicBlock has no grouped conv")
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
                 first_dilation=None, downsample=None, groups=1):
        super().__init__()
        fd = first_dilation or dilation
        out_planes = planes * self.expansion
        self.conv1 = Conv(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv(planes, planes, 3, stride, fd, fd, bias=False,
                          groups=groups)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv(planes, out_planes, 1, bias=False)
        self.bn3 = BatchNorm2d(out_planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return self.relu(out + res)


class GroupBottleneck(Bottleneck):
    """ResNeXt's bottleneck: a grouped 3x3, expansion 2 (reference
    models/resnext.py:23-60)."""

    expansion = 2


def stage_geometry(dilate_scale):
    """(strides, dilations, first dilations) of the four stages at output
    stride 32 (``dilate_scale`` None) or 8."""
    strides, dilations, first = [1, 2, 2, 2], [1, 1, 1, 1], [1, 1, 1, 1]
    if dilate_scale == 8:
        strides[2] = strides[3] = 1
        dilations[2], first[2] = 2, 1
        dilations[3], first[3] = 4, 2
    elif dilate_scale is not None:
        raise ValueError(f"dilate_scale must be None or 8, not "
                         f"{dilate_scale!r}")
    return strides, dilations, first


class ResNetFeatures(nn.Module):
    """Deep-stem ResNet trunk returning the [C2, C3, C4, C5] pyramid, at
    output stride 32, or 8 with ``dilate_scale`` 8; ``groups`` the
    3x3 convs' groups (ResNeXt), ``stage_planes`` each stage's width
    before the block's expansion."""

    def __init__(self, block=Bottleneck, layers=(3, 4, 23, 3),
                 dilate_scale: int | None = None, groups: int = 1,
                 stage_planes=(64, 128, 256, 512)):
        super().__init__()
        self.conv1 = Conv(3, 64, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = Conv(64, 64, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(64)
        self.conv3 = Conv(64, 128, 3, 1, 1, bias=False)
        self.bn3 = BatchNorm2d(128)
        self.relu = nn.ReLU(inplace=True)

        strides, dilations, first_dilations = stage_geometry(dilate_scale)

        inplanes = 128
        for stage, planes in enumerate(stage_planes):
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
                    downsample=downsample, groups=groups))
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


#: the reference's trunks by arch name: (block, layers, dilate_scale,
#: groups, stage_planes)
ARCHS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2), None, 1, (64, 128, 256, 512)),
    "resnet18dilated": (BasicBlock, (2, 2, 2, 2), 8, 1, (64, 128, 256, 512)),
    "resnet50": (Bottleneck, (3, 4, 6, 3), None, 1, (64, 128, 256, 512)),
    "resnet50dilated": (Bottleneck, (3, 4, 6, 3), 8, 1, (64, 128, 256, 512)),
    "resnet101": (Bottleneck, (3, 4, 23, 3), None, 1, (64, 128, 256, 512)),
    "resnet101dilated": (Bottleneck, (3, 4, 23, 3), 8, 1,
                         (64, 128, 256, 512)),
    # the reference's resnext101: 32 groups, expansion-2 blocks on doubled
    # stage widths, output stride 32
    "resnext101": (GroupBottleneck, (3, 4, 23, 3), None, 32,
                   (128, 256, 512, 1024)),
}


def build_encoder(arch: str) -> ResNetFeatures:
    """The ResNet and ResNeXt trunks, by the reference arch name."""
    if arch.lower() not in ARCHS:
        raise ValueError(f"encoder {arch!r} is not a ResNet; one of "
                         f"{sorted(ARCHS)}")
    block, layers, dilate_scale, groups, planes = ARCHS[arch.lower()]
    return ResNetFeatures(block, layers, dilate_scale, groups, planes)

"""The MobileNetV2 trunk with output-stride-8 dilation (JAX counterpart:
models/mobilenet.py; reference models/mobilenet.py:38-154 and the
``MobileNetV2Dilated`` wrapper, models/models.py:770-822).

The wrapper keeps ``features[:-1]`` (the stem and the 17 inverted residual
blocks, without the 1x1-1280 conv), returns the maps after blocks 2, 4, 7
and 14 and the last one ([24, 32, 64, 160, 320] channels), and applies the
ResNets' no-stride dilation to blocks 7-13 (d = 2) and 14-17 (d = 4): a
strided depthwise conv there takes stride 1 and dilation d/2, every other
depthwise conv dilation d.  Output stride 8, the only one the reference
builds.

Module names are the reference's: ``features.0.{0,1}`` the stem conv and
BatchNorm, ``features.N.conv.{0,1,3,4,6,7}`` a block's convs and
BatchNorms (``.{0,1,3,4}`` for block 1, which does not expand), so a
``state_dict()`` reads back through the JAX package's
``import_mobilenet_state_dict`` and a reference checkpoint loads as it is
(its ``features.18`` and classifier dropped, pretrained.py).
"""

from __future__ import annotations

from torch import nn

from .layers import BatchNorm2d, Conv

#: (expand ratio, output channels, blocks, stride) of each group
#: (reference models/mobilenet.py:86-94)
IR_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
#: the blocks after which the trunk taps a level (features index)
DOWN_IDX = (2, 4, 7, 14)


class InvertedResidual(nn.Module):
    """1x1 expansion (when ``expand_ratio`` > 1), 3x3 depthwise, 1x1
    projection, each with BatchNorm, ReLU6 after the first two; the input
    added back when the block keeps stride and width."""

    def __init__(self, cin: int, cout: int, stride: int, expand_ratio: int,
                 dilation: int = 1):
        super().__init__()
        hidden = round(cin * expand_ratio)
        self.use_res_connect = stride == 1 and cin == cout
        layers = []
        if expand_ratio != 1:
            layers += [Conv(cin, hidden, 1, bias=False), BatchNorm2d(hidden),
                       nn.ReLU6(inplace=True)]
        layers += [Conv(hidden, hidden, 3, stride, dilation, dilation,
                        bias=False, groups=hidden),
                   BatchNorm2d(hidden), nn.ReLU6(inplace=True),
                   Conv(hidden, cout, 1, bias=False), BatchNorm2d(cout)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res_connect else out


def block_geometry():
    """(cin, cout, stride, expand ratio, dilation) of blocks 1-17 after the
    no-stride dilation to output stride 8."""
    blocks, cin = [], 32
    for t, c, n, s in IR_SETTING:
        for i in range(n):
            blocks.append([cin, c, s if i == 0 else 1, t, 1])
            cin = c
    for idx, b in enumerate(blocks, start=1):
        if idx >= DOWN_IDX[2]:
            d = 2 if idx < DOWN_IDX[3] else 4
            b[4] = d // 2 if b[2] == 2 else d
            b[2] = 1
    return [tuple(b) for b in blocks]


class MobileNetV2Dilated(nn.Module):
    """MobileNetV2 trunk returning its five levels [C2 (stride 4), C3, C4,
    the stride-8 160-channel map, C5 (320 channels)]."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Sequential(Conv(3, 32, 3, 2, 1, bias=False), BatchNorm2d(32),
                          nn.ReLU6(inplace=True)),
            *(InvertedResidual(*b) for b in block_geometry()))

    def forward(self, x):
        outs = []
        for i, block in enumerate(self.features):
            x = block(x)
            if i in DOWN_IDX:
                outs.append(x)
        outs.append(x)
        return outs

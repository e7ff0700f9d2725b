"""Core layers (JAX counterpart: models/layers.py), NCHW.

``BatchNorm2d`` here is eval-only: running statistics, eps 1e-5 (training
waits for a later slice).  Parameter names are the reference torch ones, so
a port ``state_dict()`` reads back through the JAX package's importers.
"""

from __future__ import annotations

import torch
from torch import nn


def Conv(cin: int, cout: int, kernel_size=3, stride: int = 1,
         padding: int = 0, dilation: int = 1, bias: bool = True) -> nn.Conv2d:
    """2D conv with torch-style symmetric padding."""
    return nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding,
                     dilation=dilation, bias=bias)


BatchNorm2d = nn.BatchNorm2d


def ConvBNReLU(cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
               padding: int = 1, bias: bool = False) -> nn.Sequential:
    """conv + BN + ReLU (reference: models/models.py:53-60)."""
    return nn.Sequential(Conv(cin, cout, kernel_size, stride, padding,
                              bias=bias),
                         BatchNorm2d(cout), nn.ReLU(inplace=True))


Dropout2d = nn.Dropout2d


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init: convs kaiming-normal (fan_out, relu) with zero
    bias, BN weight 1 and bias 1e-4 with identity running statistics (the
    reference ``ModelBuilder.weights_init``, models/models.py:514-521)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                    nonlinearity="relu", generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.fill_(1e-4)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)

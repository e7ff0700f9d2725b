"""Core layers (JAX counterpart: models/layers.py), NCHW.

``BatchNorm2d`` is ``nn.BatchNorm2d``: eps 1e-5; in training it normalises
with the biased batch variance and updates the running statistics with the
unbiased one at momentum 0.1, which is the JAX layer's contract (the JAX
layer takes the variance in one pass, clamped at 0, torch in two: they
differ by f32 rounding).  Parameter names are the reference torch ones, so
a port ``state_dict()`` reads back through the JAX package's importers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def Conv(cin: int, cout: int, kernel_size=3, stride: int = 1,
         padding: int = 0, dilation: int = 1, bias: bool = True,
         groups: int = 1) -> nn.Conv2d:
    """2D conv with torch-style symmetric padding; ``groups`` as
    ``nn.Conv2d`` (ResNeXt's grouped 3x3, MobileNetV2's depthwise)."""
    return nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding,
                     dilation=dilation, bias=bias, groups=groups)


BatchNorm2d = nn.BatchNorm2d


def ConvBNReLU(cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
               padding: int = 1, bias: bool = False) -> nn.Sequential:
    """conv + BN + ReLU (reference: models/models.py:53-60)."""
    return nn.Sequential(Conv(cin, cout, kernel_size, stride, padding,
                              bias=bias),
                         BatchNorm2d(cout), nn.ReLU(inplace=True))


#: test/debug hook: overrides every Dropout2d and Dropout rate (0.0 for deterministic
#: training-curve comparisons against the JAX package, whose dropout draws
#: cannot be matched).  Read at every forward.
_DROPOUT_OVERRIDE: float | None = None


def set_dropout_override(rate: float | None) -> None:
    global _DROPOUT_OVERRIDE
    _DROPOUT_OVERRIDE = rate


class Dropout2d(nn.Module):
    """Channel dropout over NCHW (``nn.Dropout2d``) with the rate override;
    the masks come from ``generator`` (on the input's device) when one is
    set, else from the global RNG."""

    #: the mask's shape for an input of ``shape``
    @staticmethod
    def mask_shape(shape):
        return shape[:2] + (1, 1)

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None

    def forward(self, x):
        rate = self.rate if _DROPOUT_OVERRIDE is None else _DROPOUT_OVERRIDE
        if not self.training or rate == 0.0:
            return x
        keep = torch.rand(self.mask_shape(x.shape), device=x.device,
                          generator=self.generator) >= rate
        return x * (keep / (1.0 - rate))


class Dropout(Dropout2d):
    """Element dropout (``nn.Dropout``), with the same override and
    generator."""

    @staticmethod
    def mask_shape(shape):
        return shape


def set_dropout_generator(model: nn.Module,
                          generator: torch.Generator | None) -> None:
    """Give every ``Dropout2d`` and ``Dropout`` of ``model`` the generator
    of its masks."""
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.generator = generator


def log_softmax(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    return F.log_softmax(x.float(), dim=dim)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init: convs kaiming-normal (fan_out, relu) with zero
    bias, BN weight 1 and bias 1e-4 with identity running statistics (the
    reference ``ModelBuilder.weights_init``, models/models.py:514-521).  The
    non-local block's convs are convs too; its residual BatchNorm
    (``keep_init``) keeps the zero scale it is built with."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                    nonlinearity="relu", generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d) and not getattr(m, "keep_init",
                                                           False):
            m.weight.fill_(1.0)
            m.bias.fill_(1e-4)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)

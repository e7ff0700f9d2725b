"""Decoders (JAX counterpart: models/decoders.py ``C1``, ``C1DeepSup``,
``PPM``, ``PPMDeepsup``, ``PPMPyramid``, ``PPMLastConv``,
``PPMDeepsupClip``, ``PPMClip``; reference models/models.py:826-1083).

Decoders take the encoder's [C2, C3, C4, C5] and return raw logits, the
per-frame ones a tuple: (main,) in eval, (main, deep supervision) in
training for the ``*deepsup`` heads; log_softmax and NLL are in the loss
(segmentation.py).  Module names are the reference's (``cbr.0/1``,
``conv_last_1``, ``ppm.{i}.1/2``, ``conv_last_.0/1/4``, ``conv_last.0/1/4``,
``cbr_deepsup.0/1``, ``conv_last_deepsup_``), so a ``state_dict()`` reads
back through the JAX package's ``import_c1_state_dict`` and
``import_ppm_decoder_state_dict``, and a reference checkpoint loads as it is.

Width-bucketed eval (``valid_hw``: C5's valid size, ops/masked.py): C1's
3x3 conv reads C5 with its band re-zeroed; the pyramid pools C5's valid
region and resizes each branch onto it, and the concat is zero on the band,
so the 3x3 conv after it is exact on the valid region.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.interpolate import resize_bilinear
from ..ops.masked import adaptive_avg_pool2d_rt, mask_valid, resize_bilinear_rt
from .layers import BatchNorm2d, Conv, ConvBNReLU, Dropout2d


def pyramid_concat(conv5, branches, feat_valid=None):
    """cat([conv5, branches resized to conv5's grid]) along channels.  With
    ``feat_valid`` (conv5's valid size) conv5's band is re-zeroed in place
    and each branch is resized onto the valid region, zero beyond it: the
    concat is the unpadded run's there and zero on the band."""
    size = conv5.shape[-2:]
    if feat_valid is None:
        return torch.cat([conv5] + [resize_bilinear(p, size)
                                    for p in branches], 1)
    return torch.cat([mask_valid(conv5, feat_valid)] + [
        resize_bilinear_rt(p, size, p.shape[-2:], feat_valid)
        for p in branches], 1)


class PPMPyramid(nn.ModuleList):
    """Pooling pyramid: cat([conv5, branches...]) along channels, each branch
    adaptive-avg-pool at its scale, 1x1 conv + BN + ReLU, bilinear back."""

    def __init__(self, fc_dim: int, pool_scales=(1, 2, 3, 6)):
        super().__init__(
            nn.Sequential(nn.AdaptiveAvgPool2d(scale),
                          Conv(fc_dim, 512, 1, bias=False),
                          BatchNorm2d(512), nn.ReLU(inplace=True))
            for scale in pool_scales)

    def forward(self, conv5, valid_hw=None):
        """``valid_hw``: conv5's valid size in width-bucketed eval."""
        if valid_hw is None:
            return pyramid_concat(conv5, [branch(conv5) for branch in self])
        return pyramid_concat(conv5, [
            branch[1:](adaptive_avg_pool2d_rt(conv5, branch[0].output_size,
                                              valid_hw))
            for branch in self], valid_hw)


class PPMLastConv(nn.Sequential):
    """conv3x3 + BN + ReLU (+ dropout + classifier) tail of the PPM heads;
    ``num_class=None`` stops at the 512-d embedding."""

    def __init__(self, num_class: int | None, in_dim: int):
        layers = [Conv(in_dim, 512, 3, padding=1, bias=False),
                  BatchNorm2d(512), nn.ReLU(inplace=True)]
        if num_class is not None:
            layers += [Dropout2d(0.1), Conv(512, num_class, 1)]
        super().__init__(*layers)


class PPMDeepsupClip(nn.Module):
    """PPM head returning (deepsup logits, 512-d embedding, ppm concat) for
    the temporal fusion modules (reference models/models.py:997-1044).  The
    deep-supervision branch over C4 only feeds training losses: it is None
    in eval mode."""

    def __init__(self, num_class: int = 150, fc_dim: int = 4096,
                 pool_scales=(1, 2, 3, 6)):
        super().__init__()
        self.ppm = PPMPyramid(fc_dim, pool_scales)
        self.conv_last_ = PPMLastConv(None, fc_dim + len(pool_scales) * 512)
        self.cbr_deepsup = ConvBNReLU(fc_dim // 2, fc_dim // 4)
        self.dropout_deepsup = Dropout2d(0.1)
        self.conv_last_deepsup_ = Conv(fc_dim // 4, num_class, 1)

    def forward(self, conv_out, valid_hw=None):
        """``valid_hw``: C5's valid size in width-bucketed eval."""
        deepsup, ppm_out = self.ppm_deepsup(conv_out, valid_hw)
        return deepsup, self.conv_last_(ppm_out), ppm_out

    def ppm_deepsup(self, conv_out, valid_hw=None):
        """(deepsup logits or None, ppm concat) without the embedding: what
        ETC and NetWarp read."""
        ppm_out = self.ppm(conv_out[-1], valid_hw)
        if not self.training:
            return None, ppm_out
        d = self.dropout_deepsup(self.cbr_deepsup(conv_out[-2]))
        return self.conv_last_deepsup_(d), ppm_out


class PPMClip(nn.Module):
    """PPM embedding head without classifier (reference
    models/models.py:1046-1083): the 512-d embedding.  The reference builds
    ``cbr_deepsup`` and never uses it; it is kept so that a reference
    ``state_dict`` loads (the JAX importer drops it)."""

    def __init__(self, fc_dim: int = 4096, pool_scales=(1, 2, 3, 6)):
        super().__init__()
        self.ppm = PPMPyramid(fc_dim, pool_scales)
        self.conv_last_ = PPMLastConv(None, fc_dim + len(pool_scales) * 512)
        self.cbr_deepsup = ConvBNReLU(fc_dim // 2, fc_dim // 4)

    def forward(self, conv_out, valid_hw=None):
        return self.conv_last_(self.ppm(conv_out[-1], valid_hw))


class C1(nn.Module):
    """One 3x3 conv + BN + ReLU and a 1x1 classifier over C5 (reference
    models/models.py:862-886)."""

    def __init__(self, num_class: int = 150, fc_dim: int = 2048):
        super().__init__()
        self.cbr = ConvBNReLU(fc_dim, fc_dim // 4)
        self.conv_last_1 = Conv(fc_dim // 4, num_class, 1)

    def forward(self, conv_out, valid_hw=None):
        c5 = conv_out[-1]
        if valid_hw is not None:
            c5 = mask_valid(c5, valid_hw)
        return (self.conv_last_1(self.cbr(c5)),)


class C1DeepSup(nn.Module):
    """C1 plus, in training, a deep-supervision C1 over C4 (reference
    models/models.py:826-859)."""

    def __init__(self, num_class: int = 150, fc_dim: int = 2048):
        super().__init__()
        self.cbr = ConvBNReLU(fc_dim, fc_dim // 4)
        self.conv_last_ = Conv(fc_dim // 4, num_class, 1)
        self.cbr_deepsup = ConvBNReLU(fc_dim // 2, fc_dim // 4)
        self.conv_last_deepsup_ = Conv(fc_dim // 4, num_class, 1)

    def forward(self, conv_out, valid_hw=None):
        c5 = conv_out[-1]
        if valid_hw is not None:
            c5 = mask_valid(c5, valid_hw)
        x = self.conv_last_(self.cbr(c5))
        if not self.training:
            return (x,)
        return x, self.conv_last_deepsup_(self.cbr_deepsup(conv_out[-2]))


class PPM(nn.Module):
    """PSPNet head: the pooling pyramid over C5 and the classifier tail
    (reference models/models.py:889-935)."""

    def __init__(self, num_class: int = 150, fc_dim: int = 4096,
                 pool_scales=(1, 2, 3, 6)):
        super().__init__()
        self.ppm = PPMPyramid(fc_dim, pool_scales)
        self.conv_last = PPMLastConv(num_class,
                                     fc_dim + len(pool_scales) * 512)

    def forward(self, conv_out, valid_hw=None):
        return (self.conv_last(self.ppm(conv_out[-1], valid_hw)),)


class PPMDeepsup(nn.Module):
    """PSPNet head plus, in training, a deep-supervision branch over C4
    with dropout (reference models/models.py:938-995): the per-frame
    baseline's head (``ppm_deepsup``)."""

    def __init__(self, num_class: int = 150, fc_dim: int = 4096,
                 pool_scales=(1, 2, 3, 6)):
        super().__init__()
        self.ppm = PPMPyramid(fc_dim, pool_scales)
        self.conv_last_ = PPMLastConv(num_class,
                                      fc_dim + len(pool_scales) * 512)
        self.cbr_deepsup = ConvBNReLU(fc_dim // 2, fc_dim // 4)
        self.dropout_deepsup = Dropout2d(0.1)
        self.conv_last_deepsup_ = Conv(fc_dim // 4, num_class, 1)

    def forward(self, conv_out, valid_hw=None):
        x = self.conv_last_(self.ppm(conv_out[-1], valid_hw))
        if not self.training:
            return (x,)
        d = self.dropout_deepsup(self.cbr_deepsup(conv_out[-2]))
        return x, self.conv_last_deepsup_(d)

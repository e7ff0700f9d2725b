"""Decoders (JAX counterpart: models/decoders.py ``C1``, ``C1DeepSup``,
``PPM``, ``PPMDeepsup``, ``PPMPyramid``, ``PPMLastConv``,
``PPMDeepsupClip``, ``PPMClip``, ``UPerNet``; reference
models/models.py:826-1172).

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
so the 3x3 conv after it is exact on the valid region.  UPerNet spans the
four strides, so it takes the input-level ``valid_hw`` and ``pad_hw``
(``spans_strides``) and derives each level's valid size itself.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.interpolate import resize_bilinear
from ..ops.masked import (adaptive_avg_pool2d_rt, feature_valid, mask_valid,
                          resize_bilinear_rt)
from ..ops.pooling import adaptive_avg_pool2d
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


def _conv1x1_bn_relu(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(Conv(cin, cout, 1, bias=False), BatchNorm2d(cout),
                         nn.ReLU(inplace=True))


class UPerNet(nn.Module):
    """Pooling pyramid + FPN (reference models/models.py:1085-1172):
    ``upernet`` (fpn_dim 512) and ``upernet_lite`` (256) over a
    [C2, C3, C4, C5] trunk whose channels are ``fpn_inplanes`` (every ResNet
    and ResNeXt: fc_dim / 8, / 4, / 2, fc_dim).  Returns (logits,) at C2's
    stride.  Module names are the reference's (``ppm_conv.{i}``,
    ``ppm_last_conv``, ``fpn_in.{i}``, ``fpn_out.{i}.0``, ``conv_last_``),
    which the JAX package's ``import_upernet_decoder_state_dict`` reads."""

    #: takes the input-level valid and padded sizes in bucketed eval
    #: (models/segmentation.py)
    spans_strides = True

    def __init__(self, num_class: int = 150, fc_dim: int = 4096,
                 pool_scales=(1, 2, 3, 6), fpn_inplanes=None,
                 fpn_dim: int = 256):
        super().__init__()
        if fpn_inplanes is None:
            fpn_inplanes = (fc_dim // 8, fc_dim // 4, fc_dim // 2, fc_dim)
        self.fpn_inplanes = tuple(fpn_inplanes)
        self.pool_scales = tuple(pool_scales)
        self.ppm_conv = nn.ModuleList(_conv1x1_bn_relu(fc_dim, 512)
                                      for _ in pool_scales)
        self.ppm_last_conv = ConvBNReLU(fc_dim + len(pool_scales) * 512,
                                        fpn_dim)
        self.fpn_in = nn.ModuleList(_conv1x1_bn_relu(c, fpn_dim)
                                    for c in self.fpn_inplanes[:-1])
        self.fpn_out = nn.ModuleList(nn.Sequential(ConvBNReLU(fpn_dim,
                                                              fpn_dim))
                                     for _ in self.fpn_inplanes[:-1])
        self.conv_last_ = nn.Sequential(
            ConvBNReLU(len(self.fpn_inplanes) * fpn_dim, fpn_dim),
            Conv(fpn_dim, num_class, 1))

    @staticmethod
    def top_down(f, size, f_valid=None, valid=None):
        """The FPN's top-down resize of ``f`` onto a lateral's grid
        ``size``; bucketed, the valid region ``f_valid`` onto ``valid``."""
        if f_valid is None:
            return resize_bilinear(f, size)
        return resize_bilinear_rt(f, size, f_valid, valid)

    def forward(self, conv_out, valid_hw=None, pad_hw=None):
        """``valid_hw`` / ``pad_hw``: the input's valid and padded sizes in
        width-bucketed eval; each level's valid size by the ratio rule
        (JAX decoders.py:237-296).  Every 3x3 conv's input has its band
        zero: the trunk's levels arrive so (``masked_encode``), the
        pyramid's branches and the laterals are re-zeroed (B6), the resizes
        are the ``*_rt`` products, zero beyond the valid region."""
        got = tuple(c.shape[1] for c in conv_out)
        if got != self.fpn_inplanes:
            raise ValueError(f"UPerNet expects a trunk of channels "
                             f"{self.fpn_inplanes}, got {got}")
        masked = valid_hw is not None
        fv = ([feature_valid(*c.shape[-2:], valid_hw, pad_hw)
               for c in conv_out] if masked else [None] * len(conv_out))
        conv5 = conv_out[-1]                 # its band zero (masked_encode)
        size = conv5.shape[-2:]
        ppm_out = [conv5]
        for scale, branch in zip(self.pool_scales, self.ppm_conv):
            if masked:
                p = resize_bilinear_rt(
                    adaptive_avg_pool2d_rt(conv5, scale, fv[-1]), size,
                    (scale, scale), fv[-1])
                ppm_out.append(mask_valid(branch(p), fv[-1]))
            else:
                ppm_out.append(branch(resize_bilinear(
                    adaptive_avg_pool2d(conv5, scale), size)))
        f = self.ppm_last_conv(torch.cat(ppm_out, 1))

        fpn_features = [f]
        f_fv = fv[-1]
        for i in reversed(range(len(conv_out) - 1)):
            lateral = self.fpn_in[i](conv_out[i])
            if masked:
                lateral = mask_valid(lateral, fv[i])
            f = lateral + self.top_down(f, lateral.shape[-2:], f_fv, fv[i])
            f_fv = fv[i]
            fpn_features.append(self.fpn_out[i](f))
        fpn_features.reverse()                               # [P2 ... P5]

        out_hw = fpn_features[0].shape[-2:]
        if masked:
            fusion = [mask_valid(fpn_features[0], fv[0])] + [
                resize_bilinear_rt(p, out_hw, fv[j + 1], fv[0])
                for j, p in enumerate(fpn_features[1:])]
        else:
            fusion = [fpn_features[0]] + [resize_bilinear(p, out_hw)
                                          for p in fpn_features[1:]]
        return (self.conv_last_(torch.cat(fusion, 1)),)

"""The DeepLabV3+ decoder: ASPP over C5 and the low-level decoder over C2
(JAX counterpart: models/deeplab.py; reference models/deeplab.py:36-168).

On an output-stride-8 trunk ASPP's dilations are (1, 12, 24, 36).  The
image-pool branch and the OS8 -> OS4 merge upsample with
``align_corners=True``, as the reference.  Its three dropouts (ASPP's 0.5,
the fusion's 0.5, the classifier's 0.1) are ``layers.Dropout``: element
dropout drawn from the model's generator (``set_dropout_generator``).

Module names are the reference's (``aspp.aspp{1-4}.{atrous_conv,bn}``,
``aspp.global_avg_pool.{1,2}``, ``aspp.{conv1,bn1}``,
``decoder.{conv1,bn1}``, ``decoder.last_conv.{0,1,4,5}``,
``decoder.lastlast_conv.1``), which the JAX package's
``import_deeplab_decoder_state_dict`` reads.

Width-bucketed eval: the head spans two strides, so it takes the input's
valid and padded sizes (``spans_strides``) and derives C5's and C2's valid
sizes by the ratio rule.  C5 arrives with its band zero (masked_encode),
so the dilated branches are exact on the valid region; the image pool
averages the valid region only; ASPP's output, the low-level features and
each fusion conv's output are re-zeroed (B6), and the merge resize is the
``*_rt`` product.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.interpolate import resize_bilinear
from ..ops.masked import (feature_valid, global_avg_pool_rt, mask_valid,
                          resize_bilinear_rt)
from .layers import BatchNorm2d, Conv, Dropout


class _ASPPBranch(nn.Module):
    def __init__(self, cin: int, kernel_size: int, dilation: int):
        super().__init__()
        pad = 0 if kernel_size == 1 else dilation
        self.atrous_conv = Conv(cin, 256, kernel_size, padding=pad,
                                dilation=dilation, bias=False)
        self.bn = BatchNorm2d(256)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        return self.relu(self.bn(self.atrous_conv(x)))


class ASPP(nn.Module):
    """Four atrous branches and the image pool, concatenated, then a 1x1
    conv to 256 channels and dropout 0.5."""

    def __init__(self, cin: int, dilations=(1, 12, 24, 36)):
        super().__init__()
        for i, d in enumerate(dilations):
            self.add_module(f"aspp{i + 1}",
                            _ASPPBranch(cin, 1 if i == 0 else 3, d))
        self.global_avg_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), Conv(cin, 256, 1, bias=False),
            BatchNorm2d(256), nn.ReLU(inplace=True))
        self.conv1 = Conv(256 * (len(dilations) + 1), 256, 1, bias=False)
        self.bn1 = BatchNorm2d(256)
        self.relu = nn.ReLU(inplace=True)
        self.dropout = Dropout(0.5)
        self.n_branches = len(dilations)

    def forward(self, x, valid_hw=None):
        """``valid_hw``: x's valid size in bucketed eval (x's band zero)."""
        branches = [getattr(self, f"aspp{i + 1}")(x)
                    for i in range(self.n_branches)]
        g = (self.global_avg_pool[0](x) if valid_hw is None
             else global_avg_pool_rt(x, valid_hw))
        g = self.global_avg_pool[1:](g)
        branches.append(resize_bilinear(g, x.shape[-2:], align_corners=True))
        x = self.relu(self.bn1(self.conv1(torch.cat(branches, 1))))
        return self.dropout(x)


class _Decoder(nn.Module):
    def __init__(self, num_class: int, low_planes: int):
        super().__init__()
        self.conv1 = Conv(low_planes, 48, 1, bias=False)
        self.bn1 = BatchNorm2d(48)
        self.relu = nn.ReLU(inplace=True)
        self.last_conv = nn.Sequential(
            Conv(304, 256, 3, padding=1, bias=False), BatchNorm2d(256),
            nn.ReLU(inplace=True), Dropout(0.5),
            Conv(256, 256, 3, padding=1, bias=False), BatchNorm2d(256),
            nn.ReLU(inplace=True))
        self.lastlast_conv = nn.Sequential(Dropout(0.1),
                                           Conv(256, num_class, 1))


class DeepLab(nn.Module):
    """ASPP over C5 merged with C2's low-level features at C2's stride;
    returns (logits,) at C2's stride."""

    #: takes the input-level valid and padded sizes in bucketed eval
    #: (models/segmentation.py)
    spans_strides = True

    def __init__(self, num_class: int = 150, fc_dim: int = 2048):
        super().__init__()
        self.fc_dim = fc_dim
        self.aspp = ASPP(fc_dim)
        self.decoder = _Decoder(num_class, fc_dim // 8)

    def forward(self, conv_out, valid_hw=None, pad_hw=None):
        """``valid_hw`` / ``pad_hw``: the input's valid and padded sizes in
        width-bucketed eval."""
        c5, c2 = conv_out[-1], conv_out[-4]
        want = (self.fc_dim // 8, self.fc_dim)
        if (c2.shape[1], c5.shape[1]) != want:
            raise ValueError(f"DeepLab expects C2 and C5 of channels {want}, "
                             f"got {(c2.shape[1], c5.shape[1])}")
        masked = valid_hw is not None
        fv8 = fv4 = None
        if masked:
            fv8 = feature_valid(*c5.shape[-2:], valid_hw, pad_hw)
            fv4 = feature_valid(*c2.shape[-2:], valid_hw, pad_hw)
        x = self.aspp(c5, fv8)
        dec = self.decoder
        low = dec.relu(dec.bn1(dec.conv1(c2)))
        if masked:
            low = mask_valid(low, fv4)
            x = resize_bilinear_rt(mask_valid(x, fv8), low.shape[-2:], fv8,
                                   fv4, align_corners=True)
        else:
            x = resize_bilinear(x, low.shape[-2:], align_corners=True)
        x = torch.cat([x, low], 1)
        last = dec.last_conv
        for stage in (last[:3], last[3:]):
            x = stage(x)
            if masked:
                x = mask_valid(x, fv4)
        return (dec.lastlast_conv(x),)

"""OCR (Object-Contextual Representations) blocks (JAX counterpart:
models/ocr.py; reference models/ocr_modules/spatial_ocr_block.py:39-380).

* :func:`spatial_gather`: class-probability-weighted region features, a
  softmax over the pixels of each class, then a [K, HW] x [HW, C] product;
* :class:`ObjectAttentionBlock2D`: pixel queries against region keys and
  values, scaled by ``key_channels ** -0.5``;
* :class:`SpatialOCR`: the attention context concatenated with the
  features and fused by a 1x1 conv.
* :class:`SpatialOCRAsDec`: the OCR decoder without its classifier
  (reference netwarp_ocr.py:65-115), the decoder of ``netwarp_ocr`` and
  ``etc_ocr``;
* :class:`SpatialOCRNet`: the per-frame OCRNet decoder ``ocrnet_deepsup``
  (reference ocrnet.py:22-72), the same blocks and a 1x1 classifier.

Region features are the reference's [N, C, K, 1] images, transformed by
1x1 ``Conv2d`` + ``BatchNorm2d`` (BN over (N, K)); the JAX package carries
them as [N, K, C] with the same statistics.  Module names are the
reference's (``f_pixel.{0,1,3,4}``, ``f_object``, ``f_down``, ``f_up``,
``conv_bn_dropout``, ``conv_3x3``, ``dsn_head``, ``head``), so a
``state_dict()`` reads back through the JAX package's
``import_ocr_decoder_state_dict``.  Every conv carries a bias, as the JAX
modules' do.  The two products of the attention and the gather's product
are ``torch.matmul``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.masked import mask_valid
from .layers import BatchNorm2d, Conv, Dropout2d


def spatial_gather(feats: torch.Tensor, probs: torch.Tensor,
                   scale: float = 1.0, valid=None) -> torch.Tensor:
    """feats [N, C, H, W], logits ``probs`` [N, K, H, W] → region features
    [N, C, K, 1].

    ``valid``: the (rows, cols) of the true feature map inside a
    width-bucketed padded grid (ops/masked.py): the band gets -inf logits
    before the softmax over pixels, so the gather equals the unpadded
    run's."""
    n, c, h, w = feats.shape
    k = probs.shape[1]
    p = probs.float()
    if valid is not None and (valid[0] < h or valid[1] < w):
        band = torch.ones(h, w, dtype=torch.bool, device=p.device)
        band[:valid[0], :valid[1]] = False
        p = p.masked_fill(band, float("-inf"))
    p = torch.softmax(scale * p.reshape(n, k, h * w), dim=2)
    ctx = torch.matmul(p, feats.float().reshape(n, c, h * w).transpose(1, 2))
    return ctx.transpose(1, 2).unsqueeze(3).to(feats.dtype)


def _conv_bn_relu(cin: int, cout: int) -> list[nn.Module]:
    return [Conv(cin, cout, 1), BatchNorm2d(cout), nn.ReLU(inplace=True)]


class ObjectAttentionBlock2D(nn.Module):
    """Pixel-to-region attention (reference spatial_ocr_block.py:176-291)."""

    def __init__(self, in_channels: int, key_channels: int):
        super().__init__()
        self.key_channels = key_channels
        self.f_pixel = nn.Sequential(*_conv_bn_relu(in_channels, key_channels),
                                     *_conv_bn_relu(key_channels,
                                                    key_channels))
        self.f_object = nn.Sequential(
            *_conv_bn_relu(in_channels, key_channels),
            *_conv_bn_relu(key_channels, key_channels))
        self.f_down = nn.Sequential(*_conv_bn_relu(in_channels, key_channels))
        self.f_up = nn.Sequential(*_conv_bn_relu(key_channels, in_channels))

    def forward(self, x, proxy):
        """x [N, C, H, W]; proxy (region features) [N, C, K, 1] → context
        [N, C, H, W]."""
        n, _, h, w = x.shape
        q = self.f_pixel(x).reshape(n, self.key_channels, h * w)
        key = self.f_object(proxy).flatten(2)             # [N, Ck, K]
        value = self.f_down(proxy).flatten(2)             # [N, Ck, K]
        sim = torch.matmul(q.transpose(1, 2).float(), key.float())
        sim = torch.softmax(sim * self.key_channels ** -0.5, dim=-1)
        ctx = torch.matmul(value.float(), sim.transpose(1, 2))  # [N, Ck, HW]
        ctx = ctx.reshape(n, self.key_channels, h, w).to(x.dtype)
        return self.f_up(ctx)


class SpatialOCR(nn.Module):
    """Attention context + 1x1 fuse (reference spatial_ocr_block.py:
    310-380)."""

    def __init__(self, in_channels: int, key_channels: int,
                 out_channels: int, dropout: float = 0.1):
        super().__init__()
        self.object_context_block = ObjectAttentionBlock2D(in_channels,
                                                           key_channels)
        self.conv_bn_dropout = nn.Sequential(
            *_conv_bn_relu(2 * in_channels, out_channels), Dropout2d(dropout))

    def forward(self, feats, proxy):
        ctx = self.object_context_block(feats, proxy)
        return self.conv_bn_dropout(torch.cat([ctx, feats], 1))


def dsn_head(cin: int, num_class: int) -> nn.Sequential:
    """The deep-supervision head over C4, the gather's probability source:
    a biased 3x3 conv (reference ocrnet.py:48-49, clip_ocr.py:58), BN,
    ReLU, dropout, 1x1 classifier."""
    return nn.Sequential(Conv(cin, 512, 3, padding=1), BatchNorm2d(512),
                         nn.ReLU(inplace=True), Dropout2d(0.05),
                         Conv(512, num_class, 1))


def conv_3x3(cin: int) -> nn.Sequential:
    """The 3x3 conv + BN + ReLU over C5 that gives the OCR features."""
    return nn.Sequential(Conv(cin, 512, 3, padding=1), BatchNorm2d(512),
                         nn.ReLU(inplace=True))


class SpatialOCRAsDec(nn.Module):
    """OCR decoder without classifier: (512-d features, dsn logits)
    (JAX models/netwarp.py::SpatialOCRAsDec; reference netwarp_ocr.py:
    65-115)."""

    def __init__(self, num_class: int, fc_dim: int = 2048):
        super().__init__()
        self.conv_3x3 = conv_3x3(fc_dim)
        self.dsn_head = dsn_head(fc_dim // 2, num_class)
        self.spatial_ocr_head = SpatialOCR(512, 256, 512, dropout=0.05)

    def forward(self, conv_out, feat_valid=None):
        """conv_out [..., C4, C5] → (features [N, 512, h, w], dsn logits).

        ``feat_valid``: the valid size of the OS-8 maps in width-bucketed
        eval (under inference mode).  C4 and C5 must come with a zero band:
        the two 3x3 convs are then exact on the valid region, the gather
        excludes the band, and the attention and fuse past it are per pixel.
        The features are re-zeroed on the band, so a flow warp reads zeros
        beyond the valid extent as the unpadded run's out-of-range taps
        do."""
        x_dsn = self.dsn_head(conv_out[-2])
        x = self.conv_3x3(conv_out[-1])
        x = self.spatial_ocr_head(x, spatial_gather(x, x_dsn,
                                                    valid=feat_valid))
        if feat_valid is not None:
            x = mask_valid(x, feat_valid)
        return x, x_dsn


class SpatialOCRNet(SpatialOCRAsDec):
    """The per-frame OCRNet decoder (``ocrnet_deepsup``; JAX
    models/ocr.py:152-191): the DSN head over C4, ``conv_3x3`` over C5, the
    gather, ``SpatialOCR(512, 256, 512)`` and the 1x1 ``head`` →
    (logits, dsn logits) in training, (logits,) in eval."""

    def __init__(self, num_class: int = 150, fc_dim: int = 2048):
        super().__init__(num_class, fc_dim)
        self.head = Conv(512, num_class, 1)

    def forward(self, conv_out, valid_hw=None):
        """``valid_hw``: C5's valid size in width-bucketed eval.  C4 and C5
        come with a zero band (``masked_encode``), so the two 3x3 convs are
        exact on the valid region, the gather excludes the band, and what
        follows is per pixel: the logits' valid region is the unpadded
        run's, with no re-zero of their own."""
        x_dsn = self.dsn_head(conv_out[-2])
        x = self.conv_3x3(conv_out[-1])
        x = self.head(self.spatial_ocr_head(
            x, spatial_gather(x, x_dsn, valid=valid_hw)))
        return (x, x_dsn) if self.training else (x,)

"""TCB-PSP (JAX counterpart: models/clip_psp.py; reference
models/clip_psp.py:63-217).

Every clip frame goes through the shared encoder; each frame's C5 is
adaptive-avg-pooled at scales (1, 2, 3, 6); the pooled pyramids are blended
across frames (mean, or weighted by ``psp_weight``) and fused by a PPM conv
over the target frame's C5.  ``encode_frame`` and ``fuse_target`` are the
streaming building blocks (serving.py); ``forward`` is the window form, and
in training mode it also returns the deep-supervision logits over every
frame's C4 for ``clip_psp_loss``.

Reference quirk kept: with ``psp_weight`` the pooled features are ordered
[target, others...] while the softmax weights stay in input order
[others..., target], so the product pairs them off by one; the blend stays a
mean after weighting.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.masked import (adaptive_avg_pool2d_rt, feature_valid,
                          global_avg_pool_rt, mask_valid, masked_trunk)
from ..ops.pooling import adaptive_avg_pool2d, global_avg_pool
from .decoders import pyramid_concat
from .layers import BatchNorm2d, Conv, ConvBNReLU, Dropout2d
from .resnet import build_encoder
from .segmentation import pixel_accuracy, upsampled_logprob_loss_projected


class PPMConv(nn.Module):
    """Per-scale 1x1 conv+BN+ReLU on the blended stats, then the fuse conv
    over [target C5 | upsampled stats] (reference clip_psp.py:23-56)."""

    def __init__(self, num_class: int, fc_dim: int, pool_scales):
        super().__init__()
        self.ppm = nn.ModuleList(
            ConvBNReLU(fc_dim, 512, 1, padding=0) for _ in pool_scales)
        self.conv_last_ = nn.Sequential(
            Conv(fc_dim + len(pool_scales) * 512, 512, 3, padding=1,
                 bias=False),
            BatchNorm2d(512), nn.ReLU(inplace=True), Dropout2d(0.1),
            Conv(512, num_class, 1))

    def forward(self, target_c5, blended, feat_valid=None):
        return self.conv_last_(pyramid_concat(
            target_c5, [m(f) for m, f in zip(self.ppm, blended)], feat_valid))


class ClipPSP(nn.Module):
    def __init__(self, encoder: nn.Module, num_class: int, fc_dim: int = 2048,
                 pool_scales=(1, 2, 3, 6), psp_weight: bool = False):
        super().__init__()
        self.encoder = encoder
        self.pool_scales = tuple(pool_scales)
        self.psp_weight = psp_weight
        self.ppm_conv = PPMConv(num_class, fc_dim, self.pool_scales)
        # deep supervision head over C4 (training only)
        self.deepsup = nn.Sequential(
            Conv(fc_dim // 2, fc_dim // 4, 3, padding=1, bias=False),
            BatchNorm2d(fc_dim // 4), nn.ReLU(inplace=True), Dropout2d(0.1),
            Conv(fc_dim // 4, num_class, 1))
        if psp_weight:
            self.pspweight_conv = nn.Sequential(Conv(fc_dim, 1, 1,
                                                     bias=False))

    def fuse_target(self, target_c5, blended, feat_valid=None):
        """target_c5 [B, C, h, w]; blended: per-scale [B, C, s, s] → logits
        [B, K, h, w].  ``feat_valid``: the valid (rows, cols) of target_c5
        in width-bucketed eval; its band is re-zeroed in place."""
        return self.ppm_conv(target_c5, blended, feat_valid)

    def encode_frame(self, img, valid_hw=None):
        """[B, 3, H, W] → (C5, per-scale pooled stats), plus the
        ``psp_weight`` logit [B] when enabled: ``(c5, (pooled, wp))``.

        ``valid_hw``: the true (rows, cols) of the frame inside the
        zero-padded bucket ``img`` (eval only, under inference mode).  The
        trunk runs under the spatial-conv-input mask (ops/masked.py), C5 is
        returned with a zero band, and the stats pool the valid region only:
        they equal the unpadded run's."""
        if valid_hw is None:
            c5 = self.encoder(img)[-1]
            pooled = [adaptive_avg_pool2d(c5, s) for s in self.pool_scales]
            if self.psp_weight:
                wp = global_avg_pool(self.pspweight_conv(c5)).reshape(-1)
                return c5, (pooled, wp)
            return c5, pooled
        pad_hw = img.shape[-2:]
        with masked_trunk(self.encoder, valid_hw, pad_hw):
            c5 = self.encoder(img)[-1]
        fv = feature_valid(c5.shape[2], c5.shape[3], valid_hw, pad_hw)
        c5 = mask_valid(c5, fv)
        pooled = [adaptive_avg_pool2d_rt(c5, s, fv) for s in self.pool_scales]
        if self.psp_weight:
            wp = global_avg_pool_rt(self.pspweight_conv(c5), fv).reshape(-1)
            return c5, (pooled, wp)
        return c5, pooled

    def forward(self, imgs):
        """imgs [T+1, B, 3, H, W], target LAST → (main logits [B, K, h, w],)
        and, in training mode, the deep-supervision logits
        [(T+1)*B, K, h, w] over all frames (reference clip_psp.py:205-215)."""
        t1, b = imgs.shape[:2]
        conv_out = self.encoder(imgs.flatten(0, 1))
        c5 = conv_out[-1]
        c5_t = c5.unflatten(0, (t1, b))
        psp_w = None
        if self.psp_weight:
            wp = global_avg_pool(self.pspweight_conv(c5))
            # softmax across frames, kept in INPUT order (others..., target)
            psp_w = torch.softmax(wp.reshape(t1, b, 1, 1, 1).float(), dim=0)
        blended = []
        for s in self.pool_scales:
            p = adaptive_avg_pool2d(c5, s).unflatten(0, (t1, b))
            p = torch.cat([p[-1:], p[:-1]], 0)  # target first, as reference
            if psp_w is not None:
                p = p * psp_w
            blended.append(p.mean(0))
        main = self.fuse_target(c5_t[-1], blended)
        if not self.training:
            return (main,)
        return main, self.deepsup(conv_out[-2])


def clip_psp_loss(outs, batch, deep_sup_scale: float | None = 0.4):
    """Training loss of ClipPSP → (loss, acc) (reference clip_psp.py:
    196-217).  ``batch["labels"]``: [T+1, B, H, W], target last, 255 =
    ignore.  The loss is the reference order (log_softmax at feature
    resolution, bilinear upsample, NLL) in its projected form; the accuracy
    argmaxes the upsampled raw logits, which is the same argmax."""
    main, deepsup = outs
    labels = batch["labels"]
    label = labels[-1]
    loss = upsampled_logprob_loss_projected(main, label)
    if deep_sup_scale is not None:
        loss = loss + deep_sup_scale * upsampled_logprob_loss_projected(
            deepsup, labels.flatten(0, 1))
    return loss, pixel_accuracy(main, label)


def build_clip_psp(cfg, num_class: int, psp_weight: bool = False) -> ClipPSP:
    return ClipPSP(build_encoder(cfg.MODEL.arch_encoder), num_class,
                   fc_dim=cfg.MODEL.fc_dim, psp_weight=psp_weight)

"""NetWarp: flow-guided feature warping (JAX counterpart: models/netwarp.py;
reference models/netwarp.py, models/netwarp_ocr.py).

A frozen RAFT gives the flow between the target and the previous frame
(inputs denormalized to 0-255, padded to /8), a small FlowCNN refines it
over (flow, img1, img2, img2 - img1), the shared encoder gives both frames'
features, and the previous frame's C5 and decoder features are warped by
the flow and blended into the target's with learned per-channel weights
(w0_*, w1_*) before the classifier.

Quirks kept: the flow is resized to feature resolution with NEAREST and
stays in full-resolution pixel units (netwarp.py:198, 214); the encoder
input order is [target, prev] (netwarp.py:196); netwarp_ocr's deep
supervision pairs the DSN logits [target, prev] against the labels
[prev, target] (netwarp_ocr.py:287-295).

RAFT is frozen and stays in eval mode, under ``torch.no_grad()`` (JAX's
``stop_gradient``); FlowCNN trains, BatchNorm in training mode.
``encode_frame`` and ``fuse_pair`` are the streaming building blocks
(serving.py): each frame's C5 and decoder features are computed once.
Module names are the reference's, so a ``state_dict()`` reads back through
the JAX package's ``import_netwarp_state_dict``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.interpolate import resize_nearest
from ..ops.masked import (feature_valid, mask_valid, masked_encode,
                          masked_trunk, resize_nearest_rt)
from ..ops.warp import flowwarp
from .decoders import PPMDeepsupClip, PPMLastConv
from .etc import denormalize_255
from .layers import Conv, ConvBNReLU
from .ocr import SpatialOCRAsDec
from .raft import RAFT, bucketed_flow, pad_to_multiple_of_8, unpad
from .resnet import build_encoder
from .segmentation import pixel_accuracy, upsampled_logprob_loss_projected


class FlowCNN(nn.Module):
    """Flow refiner (reference netwarp.py:49-63)."""

    def __init__(self):
        super().__init__()
        self.conv1 = ConvBNReLU(11, 16)
        self.conv2 = ConvBNReLU(16, 32)
        self.conv3 = ConvBNReLU(32, 2)
        self.conv4 = ConvBNReLU(4, 2)

    def forward(self, img1, img2, flow):
        x = torch.cat([flow, img1, img2, img2 - img1], 1)
        x = self.conv3(self.conv2(self.conv1(x)))
        return self.conv4(torch.cat([flow, x], 1))


def _blend(w0, w1, a, b):
    return w0.view(1, -1, 1, 1) * a + w1.view(1, -1, 1, 1) * b


class NetWarp(nn.Module):
    def __init__(self, encoder: nn.Module, num_class: int, fc_dim: int = 2048,
                 ocr: bool = False, raft_iters: int = 20):
        super().__init__()
        self.raft = RAFT(iters=raft_iters)
        for p in self.raft.parameters():
            p.requires_grad_(False)
        self.encoder = encoder
        self.flowcnn = FlowCNN()
        self.ocr = ocr
        self.w0_0 = nn.Parameter(torch.ones(fc_dim))
        self.w0_1 = nn.Parameter(torch.zeros(fc_dim))
        if ocr:
            self.decoder = SpatialOCRAsDec(num_class, fc_dim)
            blend_dim = 512
            self.head = Conv(512, num_class, 1)
        else:
            self.decoder = PPMDeepsupClip(num_class, fc_dim)
            blend_dim = fc_dim + 4 * 512
            self.conv_last_ = PPMLastConv(num_class, blend_dim)
        self.w1_0 = nn.Parameter(torch.ones(blend_dim))
        self.w1_1 = nn.Parameter(torch.zeros(blend_dim))

    def train(self, mode: bool = True):
        """RAFT is frozen: it stays in eval mode whatever the owner's."""
        super().train(mode)
        self.raft.eval()
        return self

    def _raft_flow(self, target, prev, valid_hw=None):
        """(``target`` and ``prev`` denormalized to 0-255, frozen RAFT's
        flow [B, 2, H, W] from the one to the other), before FlowCNN.
        ``valid_hw``: as in :meth:`_flow`; the images' band is re-zeroed
        after the denormalization, RAFT runs at the reference's /8 geometry
        inside the bucket (``bucketed_flow``) and its flow is zero beyond
        the valid size."""
        c_img = denormalize_255(target)
        c_pre = denormalize_255(prev)
        if valid_hw is None:
            with torch.no_grad():
                pad_t, pads = pad_to_multiple_of_8(c_img)
                pad_p, _ = pad_to_multiple_of_8(c_pre)
                return c_img, c_pre, unpad(self.raft(pad_t, pad_p)[1], pads)
        mask_valid(c_img, valid_hw)
        mask_valid(c_pre, valid_hw)
        return c_img, c_pre, mask_valid(
            bucketed_flow(self.raft, c_img, c_pre, valid_hw), valid_hw)

    def _flow(self, target, prev, valid_hw=None):
        """Refined flow [B, 2, H, W] from ``target`` to ``prev``
        (normalized [B, 3, H, W]).  ``valid_hw``: the true size inside a
        width-bucketed zero-padded grid (eval only): RAFT's flow as
        :meth:`_raft_flow` gives it, FlowCNN under the spatial-conv-input
        mask, and the flows are zero beyond the valid size, as a warp of
        the cached maps needs."""
        c_img, c_pre, flow = self._raft_flow(target, prev, valid_hw)
        if valid_hw is None:
            return self.flowcnn(c_img, c_pre, flow)
        with masked_trunk(self.flowcnn, valid_hw, c_img.shape[-2:]):
            refined = self.flowcnn(c_img, c_pre, flow)
        return mask_valid(refined, valid_hw)

    def _decode_feats(self, conv_out, feat_valid=None):
        """(the features that are flow-blended: the PPM concat, or the OCR
        512-d features; the deep-supervision logits, None for the PPM head
        in eval)."""
        if self.ocr:
            return self.decoder(conv_out, feat_valid)
        deepsup, ppm_out = self.decoder.ppm_deepsup(conv_out, feat_valid)
        return ppm_out, deepsup

    def _classify(self, new_feat):
        return self.head(new_feat) if self.ocr else self.conv_last_(new_feat)

    def encode_frame(self, img, valid_hw=None):
        """One frame → (C5, decoder features), and C4 for the OCR decoder's
        DSN head: the streaming cache (a previous frame's features are
        warped unblended, netwarp.py:196-217).  ``valid_hw``: the true size
        of width-bucketed zero-padded ``img`` (eval only): every level and
        the features are zero beyond their valid sizes."""
        conv_out, fv = masked_encode(self.encoder, img, valid_hw)
        feats, _ = self._decode_feats(conv_out, fv)
        if self.ocr:
            return conv_out[-1], feats, conv_out[-2]
        return conv_out[-1], feats

    def fuse_pair(self, target_img, prev_img, c5_t, c5_p, feats_p,
                  c4_t=None, valid_hw=None):
        """The pair's own work: flow, the two blends, the target's decode
        and the classifier → (logits, deepsup).  ``c4_t``: the target's C4
        (the OCR decoder's DSN head reads it).  ``valid_hw``: the true size
        in width-bucketed eval: the nearest resizes and the warps take the
        true sizes (the resize's source index and the warp's (dim - 1)
        normalisation depend on them), and the classifier reads features
        whose band is zero."""
        flow = self._flow(target_img, prev_img, valid_hw)
        fv = None if valid_hw is None else feature_valid(
            *c5_t.shape[-2:], valid_hw, target_img.shape[-2:])

        def warp(x):
            if valid_hw is None:
                return flowwarp(x, resize_nearest(flow, x.shape[-2:]))
            return flowwarp(x, resize_nearest_rt(flow, x.shape[-2:],
                                                 valid_hw, fv), valid_hw=fv)

        new_c5_t = _blend(self.w0_0, self.w0_1, c5_t, warp(c5_p))
        feats_t, deepsup = self._decode_feats([c4_t, new_c5_t], fv)
        new_feat = _blend(self.w1_0, self.w1_1, feats_t, warp(feats_p))
        if fv is not None:
            new_feat = mask_valid(new_feat, fv)
        return self._classify(new_feat), deepsup

    def forward(self, imgs):
        """imgs [2, B, 3, H, W], [prev, target] → (logits,) in eval mode,
        (logits, deepsup [2B, K, h, w], target then prev) in training."""
        prev, target = imgs[0], imgs[1]
        b = target.shape[0]
        flow = self._flow(target, prev)
        conv_out = list(self.encoder(torch.cat([target, prev], 0)))
        c5 = conv_out[-1]
        flow_1 = resize_nearest(flow, c5.shape[-2:])
        new_c5_t = _blend(self.w0_0, self.w0_1, c5[:b],
                          flowwarp(c5[b:], flow_1))
        conv_out[-1] = torch.cat([new_c5_t, c5[b:]], 0)
        feats, deepsup = self._decode_feats(conv_out)
        flow_2 = resize_nearest(flow, feats.shape[-2:])
        new_feat = _blend(self.w1_0, self.w1_1, feats[:b],
                          flowwarp(feats[b:], flow_2))
        pred = self._classify(new_feat)
        return (pred, deepsup) if self.training else (pred,)


def netwarp_loss(outs, batch, deep_sup_scale: float | None = 0.4,
                 ocr: bool = False):
    """Training loss → (loss, acc) (reference netwarp.py:219-239,
    netwarp_ocr.py:280-299).  ``batch["labels"]``: [2, B, H, W], [prev,
    target]."""
    pred, deepsup = outs
    labels = batch["labels"]
    label = labels[-1]
    loss = upsampled_logprob_loss_projected(pred, label)
    if deep_sup_scale is not None:
        if ocr:
            # DSN logits [target, prev] against labels [prev, target], as
            # the reference pairs them
            loss = loss + deep_sup_scale * upsampled_logprob_loss_projected(
                deepsup, labels.flatten(0, 1))
        else:
            loss = loss + deep_sup_scale * upsampled_logprob_loss_projected(
                deepsup[:label.shape[0]], label)
    return loss, pixel_accuracy(pred, label)


def build_netwarp(cfg, num_class: int, ocr: bool = False,
                  raft_iters: int = 20) -> NetWarp:
    return NetWarp(build_encoder(cfg.MODEL.arch_encoder), num_class,
                   fc_dim=cfg.MODEL.fc_dim, ocr=ocr, raft_iters=raft_iters)

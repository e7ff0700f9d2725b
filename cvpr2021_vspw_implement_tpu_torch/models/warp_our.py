"""our_warp: local cost-volume feature warping (JAX counterpart:
models/warp_our.py; reference models/warp_our.py and the ClipWarpNet
wrapper at models/models.py:116-282).

WarpNet embeds the decoder's 512-d clip features twice (128-d ``emb_2`` for
the distance maps, 256-d ``emb`` for the warped features), aggregates each
context frame's ``emb`` over a local window around every target pixel at
each radius of ``max_distances`` (ops/local_agg.py: sigmoid, inverse-distance
softmax or the argmax "nearest" quirk), means the scales, means the frames
with the target's own embedding (optionally scaled per frame by ``w{i}``
under ``linear_combine``) and classifies with a 1x1 conv.

Training (JAX models/warp_our.py:196-246) returns the target's logits,
the decoder's deep supervision and the all-frame head over ``emb_2``; B5's
gradients come from its explicit backward (ops/local_agg.py: the kernels
of ``local_agg_bwd.cu`` on the card, their plain version on the CPU).
``fix`` runs the encoder and decoder in eval mode and stops the gradient at
their outputs.  The parameters carry the reference's torch names
(``prop_clip.emb.{0,1}``, ``prop_clip.emb_2.{0,1}``, ``prop_clip.w{i}``,
``prop_clip.last_layer.1``, ``last_layer.1``), so a ``state_dict()`` reads
back through the JAX package's ``import_clip_warp_state_dict``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.local_agg import (local_nearest_aggregate, local_sigmoid_aggregate,
                             local_softmax_aggregate)
from ..ops.masked import feature_mask, mask_valid, masked_encode
from .decoders import PPMDeepsupClip
from .layers import Conv, ConvBNReLU, Dropout2d
from .resnet import build_encoder
from .segmentation import pixel_accuracy, upsampled_logprob_loss_projected


def warp_one_scale(target_e2, e2, es, r: int, distsoftmax: bool = False,
                   distnearest: bool = False, temp: float = 3.0,
                   valid_hw=None):
    """One (scale, context frame) aggregation (reference:
    warp_our.py:131-160): the kernel wrapper of the mode, over the feature
    valid size ``valid_hw`` when width-bucketed."""
    if distsoftmax:
        return local_softmax_aggregate(target_e2, e2, es, r, temp=temp,
                                       valid_hw=valid_hw)
    if distnearest:
        return local_nearest_aggregate(target_e2, e2, es, r,
                                       valid_hw=valid_hw)
    return local_sigmoid_aggregate(target_e2, e2, es, r, valid_hw=valid_hw)


class WarpNet(nn.Module):
    """Cost-volume warping head over clip embeddings (warp_our.py:84-189)."""

    def __init__(self, num_class: int, clip_num: int, max_distances=(10,),
                 emb_dim: int = 256, fc_dim: int = 128,
                 linear_combine: bool = False, distsoftmax: bool = False,
                 distnearest: bool = False, temp: float = 3.0,
                 in_dim: int = 512):
        super().__init__()
        self.max_distances = tuple(max_distances)
        self.linear_combine = linear_combine
        self.distsoftmax = distsoftmax
        self.distnearest = distnearest
        self.temp = temp
        self.emb = ConvBNReLU(in_dim, emb_dim)
        self.emb_2 = ConvBNReLU(in_dim, fc_dim)
        if linear_combine:
            for i in range(clip_num):
                self.register_parameter(f"w{i}", nn.Parameter(torch.full(
                    (emb_dim,), 1.0 if i == 0 else 0.2)))
        self.last_layer = nn.Sequential(Dropout2d(0.1),
                                        Conv(emb_dim, num_class, 1))

    def forward(self, clip_embs, t1: int, feat_valid=None):
        """clip_embs [t1*B, 512, h, w], target frame LAST group → (logits
        [B, K, h, w], emb2 [t1*B, fc_dim, h, w]).

        ``feat_valid``: the valid (rows, cols) of the features in
        width-bucketed eval: every spatial conv re-zeroes its input's band
        (the feature grid is the padded grid), both embeddings are
        re-zeroed, and B5 takes the valid size (the JAX package takes its
        XLA formulation there; the function is the same)."""
        with feature_mask(self, feat_valid, clip_embs.shape[-2:]):
            emb2 = self.emb_2(clip_embs)
            emb = self.emb(clip_embs)
        if feat_valid is not None:
            mask_valid(emb2, feat_valid)
            mask_valid(emb, feat_valid)
        e2 = emb2.unflatten(0, (t1, -1))
        es = emb.unflatten(0, (t1, -1))
        final = [es[-1]]
        for f in range(t1 - 1):
            per_scale = [warp_one_scale(e2[-1], e2[f], es[f], r,
                                        self.distsoftmax, self.distnearest,
                                        self.temp, feat_valid)
                         for r in self.max_distances]
            final.append(torch.stack(per_scale, 0).mean(0))
        if self.linear_combine:
            final = [getattr(self, f"w{i}").view(1, -1, 1, 1) * emb
                     for i, emb in enumerate(final)]
        fea = torch.stack(final, 0).mean(0)
        return self.last_layer(fea), emb2


class ClipWarpNet(nn.Module):
    """Encoder + PPM-clip decoder + WarpNet (models/models.py:116-282)."""

    def __init__(self, encoder: nn.Module, num_class: int,
                 fc_dim: int = 2048, clip_num: int = 4, max_distances=(10,),
                 linear_combine: bool = False, distsoftmax: bool = False,
                 distnearest: bool = False, temp: float = 3.0,
                 fix: bool = False):
        super().__init__()
        self.fix = fix
        self.encoder = encoder
        self.decoder = PPMDeepsupClip(num_class, fc_dim)
        self.prop_clip = WarpNet(num_class, clip_num, max_distances,
                                 linear_combine=linear_combine,
                                 distsoftmax=distsoftmax,
                                 distnearest=distnearest, temp=temp)
        # the all-frame supervision head over emb_2 (training only)
        self.last_layer = nn.Sequential(Dropout2d(0.1),
                                        Conv(128, num_class, 1))

    def train(self, mode: bool = True):
        """With ``fix`` the encoder and decoder stay in eval mode (their
        BatchNorm statistics frozen, the decoder's deep supervision off), as
        the JAX model runs them with ``train=False``."""
        super().train(mode)
        if mode and self.fix:
            self.encoder.eval()
            self.decoder.eval()
        return self

    def forward(self, imgs, valid_hw=None):
        """imgs [T+1, B, 3, H, W], target LAST → (logits [B, K, h, w],),
        or in training {"pred", "deepsup" ([(T+1)*B, K, h, w], None with
        ``fix``), "allsup" ([(T+1)*B, K, h, w])}.

        ``valid_hw``: the true (rows, cols) of width-bucketed zero-padded
        ``imgs`` (under inference mode): the masked trunk, each level
        re-zeroed, the decoder on C5's valid region, the head masked at
        the feature level (JAX models/warp_our.py:147-213)."""
        t1 = imgs.shape[0]
        conv_out, fv = masked_encode(self.encoder, imgs.flatten(0, 1),
                                     valid_hw)
        deepsup, clip_embs, _ = self.decoder(conv_out, fv)
        if self.fix:
            clip_embs = clip_embs.detach()
            deepsup = None if deepsup is None else deepsup.detach()
        pred, emb2 = self.prop_clip(clip_embs, t1, fv)
        if not self.training:
            return (pred,)
        return {"pred": pred, "deepsup": deepsup,
                "allsup": self.last_layer(emb2)}


def clip_warp_loss(outs, batch, deep_sup_scale: float | None = 0.4,
                   allsup: bool = False, allsup_scale: float = 0.3,
                   fix: bool = False):
    """Training loss → (loss, acc) (JAX models/warp_our.py:219-246;
    reference models/models.py:183-267): NLL of the target's logits, and
    with ``allsup`` that of the all-frame head, plus (unless ``fix``) the
    deep supervision's, scaled.  ``batch["labels"]``: [T+1, B, H, W],
    target last, 255 = ignore."""
    labels = batch["labels"]
    label = labels[-1]
    loss = upsampled_logprob_loss_projected(outs["pred"], label)
    if allsup:
        all_label = labels.flatten(0, 1)
        loss_a = upsampled_logprob_loss_projected(outs["allsup"], all_label)
        if deep_sup_scale is not None and not fix:
            loss_d = upsampled_logprob_loss_projected(outs["deepsup"],
                                                      all_label)
            loss = loss + (loss_a + loss_d * deep_sup_scale) * allsup_scale
        else:
            loss = loss + loss_a * allsup_scale
    return loss, pixel_accuracy(outs["pred"], label)


def _int_list(v):
    return [int(d) for d in v.split(",")] if isinstance(v, str) else list(v)


def build_clip_warp(cfg, num_class: int, args) -> ClipWarpNet:
    return ClipWarpNet(
        build_encoder(cfg.MODEL.arch_encoder), num_class,
        fc_dim=cfg.MODEL.fc_dim, clip_num=args.clip_num,
        max_distances=_int_list(getattr(args, "max_distances", [10])),
        linear_combine=getattr(args, "linear_combine", False),
        distsoftmax=getattr(args, "distsoftmax", False),
        distnearest=getattr(args, "distnearest", False),
        temp=getattr(args, "temp", 3.0), fix=getattr(args, "fix", False))

"""our_warp_merge: cost volumes on C4 embeddings, a prediction merged per
context frame (JAX counterpart: models/warp_our_merge.py; reference
models/warp_our_merge.py:53-270).

The distances come from a 256-d embedding of C4 (``prop_clip.emb2``) and
the warped features are a 256-d embedding of the decoder's 512-d clip
features (``prop_clip.emb``); the warp is B5 (ops/local_agg.py) with x the
target's C4 embedding, y_dist the context frame's and y_val its feature
embedding.  Each context frame gives a prediction from [target embedding |
warp] through ``last_layer2``; inference means them with the per-frame
head on the target.

Reference quirk kept: only the FIRST context frame is warped (the
``return`` sits inside the reference's frame loop, warp_our_merge.py:262).

Training (JAX models/warp_our_merge.py:91-175) returns the per-frame head
over every frame, the C4 embedding's deep supervision and the merged
prediction; B5 trains through its explicit backward (ops/local_agg.py), at
Cd 256.  The parameter names are the reference's
(``prop_clip.{emb,emb2}.{0,1}``, ``prop_clip.last_layer.1``,
``prop_clip.last_layer2.1``, ``last_layer.1``), so a ``state_dict()`` reads
back through the JAX package's ``import_warp_merge_state_dict``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.masked import feature_mask, mask_valid, masked_encode
from .decoders import PPMClip
from .layers import Conv, ConvBNReLU, Dropout2d
from .resnet import build_encoder
from .segmentation import pixel_accuracy, upsampled_logprob_loss_projected
from .warp_our import _int_list, warp_one_scale


class WarpNetMerge(nn.Module):
    def __init__(self, num_class: int, c4_dim: int, max_distances=(10,),
                 emb_dim: int = 256, distsoftmax: bool = False,
                 distnearest: bool = False, temp: float = 3.0):
        super().__init__()
        self.max_distances = tuple(max_distances)
        self.flags = (distsoftmax, distnearest, temp)
        self.emb = ConvBNReLU(512, emb_dim)
        self.emb2 = ConvBNReLU(c4_dim, emb_dim)
        # the C4 embedding's deep supervision (training only)
        self.last_layer = nn.Sequential(Dropout2d(0.1),
                                        Conv(emb_dim, num_class, 1))
        self.last_layer2 = nn.Sequential(Dropout2d(0.1),
                                         Conv(2 * emb_dim, num_class, 1))

    def forward(self, clip_embs, conv4, t1: int, feat_valid=None):
        """clip_embs [t1*B, 512, h, w], conv4 [t1*B, c4_dim, h, w], target
        LAST → (the first context frame's logits [B, K, h, w], emb
        [t1*B, emb_dim, h, w], the C4 embedding [t1*B, emb_dim, h, w]).
        ``feat_valid``: as WarpNet's."""
        with feature_mask(self, feat_valid, clip_embs.shape[-2:]):
            emb = self.emb(clip_embs)
            c4e = self.emb2(conv4)
        if feat_valid is not None:
            mask_valid(emb, feat_valid)
            mask_valid(c4e, feat_valid)
        e = emb.unflatten(0, (t1, -1))
        c4 = c4e.unflatten(0, (t1, -1))
        warp = torch.stack([warp_one_scale(c4[-1], c4[0], e[0], r,
                                           *self.flags, feat_valid)
                            for r in self.max_distances], 0).mean(0)
        return self.last_layer2(torch.cat([e[-1], warp], 1)), emb, c4e


class OurWarpMerge(nn.Module):
    """Encoder + PPM-clip decoder + WarpNetMerge (reference
    warp_our_merge.py:178-270)."""

    def __init__(self, encoder: nn.Module, num_class: int,
                 fc_dim: int = 2048, max_distances=(10,),
                 distsoftmax: bool = False, distnearest: bool = False,
                 temp: float = 3.0):
        super().__init__()
        self.encoder = encoder
        self.decoder = PPMClip(fc_dim)
        self.prop_clip = WarpNetMerge(num_class, fc_dim // 2, max_distances,
                                      distsoftmax=distsoftmax,
                                      distnearest=distnearest, temp=temp)
        self.last_layer = nn.Sequential(Dropout2d(0.1),
                                        Conv(256, num_class, 1))

    def forward(self, imgs, valid_hw=None):
        """imgs [T+1, B, 3, H, W] (T >= 1), target LAST → (logits
        [B, K, h, w],), or in training {"preds_c": [the merged logits
        [B, K, h, w]], "pred_s": the per-frame head [(T+1)*B, K, h, w],
        "deepsup": the C4 embedding's head [(T+1)*B, K, h, w]}.
        ``valid_hw``: as ClipWarpNet's (JAX models/warp_our_merge.py:
        91-147)."""
        t1, b = imgs.shape[:2]
        conv_out, fv = masked_encode(self.encoder, imgs.flatten(0, 1),
                                     valid_hw)
        clip_embs = self.decoder(conv_out, fv)
        pred, emb, c4e = self.prop_clip(clip_embs, conv_out[-2], t1, fv)
        if self.training:
            return {"preds_c": [pred], "pred_s": self.last_layer(emb),
                    "deepsup": self.prop_clip.last_layer(c4e)}
        pred_s = self.last_layer(emb.unflatten(0, (t1, b))[-1])
        return (torch.stack([pred_s, pred], 0).mean(0),)


def warp_merge_loss(outs, batch, deep_sup_scale: float | None = 0.4):
    """Training loss → (loss, acc) (JAX models/warp_our_merge.py:150-175;
    reference warp_our_merge.py:78-110): the merged predictions' NLL on the
    target plus the per-frame head's and the deep supervision's on every
    frame, both scaled by ``deep_sup_scale`` (the reference's quirk)."""
    labels = batch["labels"]
    label = labels[-1]
    all_label = labels.flatten(0, 1)
    scale = deep_sup_scale if deep_sup_scale is not None else 1.0
    loss_s = (upsampled_logprob_loss_projected(outs["pred_s"], all_label)
              + upsampled_logprob_loss_projected(outs["deepsup"], all_label)
              ) * scale
    losses = [upsampled_logprob_loss_projected(p, label)
              for p in outs["preds_c"]]
    loss = sum(losses) / len(losses) + loss_s
    return loss, pixel_accuracy(outs["preds_c"][-1], label)


def build_warp_merge(cfg, num_class: int, args) -> OurWarpMerge:
    return OurWarpMerge(
        build_encoder(cfg.MODEL.arch_encoder), num_class,
        fc_dim=cfg.MODEL.fc_dim,
        max_distances=_int_list(getattr(args, "max_distances", [10])),
        distsoftmax=getattr(args, "distsoftmax", False),
        distnearest=getattr(args, "distnearest", False),
        temp=getattr(args, "temp", 3.0))

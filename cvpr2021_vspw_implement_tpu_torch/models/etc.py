"""ETC: temporal-consistency training (JAX counterpart: models/etc.py;
reference models/ETC.py).

Training computes per-frame predictions for (prev, target), the NLL +
deep-supervision loss on the target frame, and a temporal-consistency MSE
between the target prediction and the flow-warped previous prediction,
masked by the occlusion estimate ``exp(-|sum_c(I_t - warp(I_{t-1}))|)``
(ETC.py:170-178).  Inference is plain single-frame (ETC.py:183-189).  The
flow comes from a frozen RAFT that stays in eval mode.

Quirks kept: the flow stays in full-resolution pixel units; the warped image
of the occlusion mask is the *normalized* previous frame.  The OCR variant
(``ocr=True``, ``--method etc_ocr``; reference ETC_ocr.py) decodes with
``SpatialOCRAsDec`` and a 1x1 classifier, and its deep supervision pairs
the predictions [target, prev] against the labels [prev, target]
(ETC_ocr.py:203-210).
"""

from __future__ import annotations

import torch
from torch import nn

from ..data.datasets import MEAN, STD
from ..ops.interpolate import resize_bilinear, resize_nearest
from ..ops.masked import masked_encode
from ..ops.warp import flowwarp
from ..utils.metrics import pixel_acc
from .decoders import PPMDeepsupClip, PPMLastConv
from .layers import Conv
from .ocr import SpatialOCRAsDec
from .raft import RAFT, pad_to_multiple_of_8, unpad
from .resnet import build_encoder
from .segmentation import upsampled_logprob_loss_projected


def denormalize_255(img: torch.Tensor) -> torch.Tensor:
    """Undo the ImageNet normalization of [N, 3, H, W] back to 0-255
    (reference netwarp.py:161-168)."""
    std = torch.as_tensor(STD, device=img.device).view(1, 3, 1, 1)
    mean = torch.as_tensor(MEAN, device=img.device).view(1, 3, 1, 1)
    return (img * std + mean) * 255.0


class ETC(nn.Module):
    def __init__(self, encoder: nn.Module, num_class: int,
                 fc_dim: int = 2048, raft_iters: int = 20, ocr: bool = False):
        super().__init__()
        self.raft = RAFT(iters=raft_iters)
        for p in self.raft.parameters():
            p.requires_grad_(False)
        self.encoder = encoder
        self.ocr = ocr
        if ocr:
            self.decoder = SpatialOCRAsDec(num_class, fc_dim)
            self.conv_last_ = Conv(512, num_class, 1)
        else:
            self.decoder = PPMDeepsupClip(num_class, fc_dim)
            self.conv_last_ = PPMLastConv(num_class, fc_dim + 4 * 512)

    def train(self, mode: bool = True):
        """RAFT is frozen: it stays in eval mode (its context encoder's
        BatchNorm keeps its running statistics) whatever the owner's mode."""
        super().train(mode)
        self.raft.eval()
        return self

    def forward(self, imgs, valid_hw=None):
        """imgs [2, B, 3, H, W], [prev, target].  Training mode: a dict of
        ``pred_t``, ``pred_p`` [B, K, h, w], ``deepsup`` [2B, K, h, w]
        (target then prev) and ``flow`` [B, 2, H, W]; eval mode: (logits of
        imgs[-1],).

        ``valid_hw``: the true (rows, cols) of width-bucketed zero-padded
        ``imgs`` (eval only, under inference mode): the masked trunk, each
        level re-zeroed, the decoder on C5's valid region; the PPM concat is
        zero on the band, so ``conv_last_``'s 3x3 is exact (the OCR decoder
        excludes the band from its gather; JAX models/etc.py:64-86)."""
        target = imgs[-1]
        if not self.training:
            conv_out, fv = masked_encode(self.encoder, target, valid_hw)
            return (self._decode(conv_out, fv)[0],)

        prev = imgs[0]
        b = target.shape[0]
        with torch.no_grad():
            pad_t, pads = pad_to_multiple_of_8(denormalize_255(target))
            pad_p, _ = pad_to_multiple_of_8(denormalize_255(prev))
            flow = unpad(self.raft(pad_t, pad_p)[1], pads)

        conv_out = self.encoder(torch.cat([target, prev], 0))
        pred, deepsup = self._decode(conv_out)
        return {"pred_t": pred[:b], "pred_p": pred[b:], "deepsup": deepsup,
                "flow": flow}

    def _decode(self, conv_out, feat_valid=None):
        """→ (logits, deepsup logits; None for the PPM head in eval)."""
        if self.ocr:
            feats, deepsup = self.decoder(conv_out, feat_valid)
            return self.conv_last_(feats), deepsup
        deepsup, ppm_out = self.decoder.ppm_deepsup(conv_out, feat_valid)
        return self.conv_last_(ppm_out), deepsup


def etc_loss(outs, batch, deep_sup_scale: float | None = 0.4,
             st_weight: float = 0.1, ocr: bool = False):
    """Training loss → (loss, acc) (reference ETC.py:141-181,
    ETC_ocr.py:160-222)."""
    prev_img, target_img = batch["img"][0].float(), batch["img"][1].float()
    labels = batch["labels"]
    label = labels[-1]
    size = label.shape[1:3]
    b = label.shape[0]
    pred_t, pred_p = outs["pred_t"], outs["pred_p"]
    loss = upsampled_logprob_loss_projected(pred_t, label)
    if deep_sup_scale is not None:
        # etc_ocr: predictions [target, prev] against labels [prev, target]
        # (the reference's quirk)
        deepsup, dlabel = ((outs["deepsup"], labels.flatten(0, 1)) if ocr
                           else (outs["deepsup"][:b], label))
        loss = loss + deep_sup_scale * upsampled_logprob_loss_projected(
            deepsup, dlabel)

    # temporal consistency (ETC.py:170-178)
    flow = resize_nearest(outs["flow"], size).float()
    pred_t_up = resize_bilinear(pred_t.float(), size)
    pred_p_up = resize_bilinear(pred_p.float(), size)
    warp_img = flowwarp(prev_img, flow)
    warp_pred = flowwarp(pred_p_up, flow)
    noc = torch.exp(-torch.abs((target_img - warp_img).sum(1, keepdim=True)))
    st = torch.mean(torch.square(pred_t_up * noc - warp_pred * noc))
    loss = loss + st_weight * st

    acc = pixel_acc(pred_t_up.detach(), torch.where(label == 255, -1, label))
    return loss, acc


def build_etc(cfg, num_class: int, raft_iters: int = 20,
              ocr: bool = False) -> ETC:
    return ETC(build_encoder(cfg.MODEL.arch_encoder), num_class,
               fc_dim=cfg.MODEL.fc_dim, raft_iters=raft_iters, ocr=ocr)

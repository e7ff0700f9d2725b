"""TCB-OCR: OCR with region contexts blended across the clip (JAX
counterpart: models/clip_ocr.py; reference models/clip_ocr.py:23-198).

Every clip frame goes through the shared encoder and the DSN head over C4;
each frame's region context (``spatial_gather`` of the OCR features by the
DSN logits, [B, 512, K, 1]) is averaged across the clip, or, at inference
with ``memory``, across a ring of the last ``memory_num + 1`` contexts
(reference spatial_ocr_block.py:110-129, clip_ocr.py:124-131); the OCR
attention then runs on the target frame against the blended context.
``encode_frame`` and ``fuse_target`` are the streaming building blocks
(serving.py): each frame is encoded once and its context reused by every
window that holds it.

With ``clipocr_all`` the reference attends all (T+1)*B frames against a
[B]-batched context, which only broadcasts at B = 1; the blended context is
tiled across the frames (the JAX package's reading, the same at B = 1).

Module names are the reference's (``conv_3x3``, ``dsn_head``,
``spatial_ocr_head``, ``head``), so a ``state_dict()`` reads back through
the JAX package's ``import_clip_ocr_state_dict``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.masked import feature_valid, mask_valid, masked_trunk
from .layers import Conv
from .ocr import SpatialOCR, conv_3x3, dsn_head, spatial_gather
from .resnet import build_encoder
from .segmentation import pixel_accuracy, upsampled_logprob_loss_projected


def init_memory(memory_num: int, batch: int, num_class: int,
                channels: int = 512, device=None):
    """An empty streaming memory: (ring [memory_num + 1, B, C, K, 1] of
    zeros, the count of valid entries)."""
    return (torch.zeros(memory_num + 1, batch, channels, num_class, 1,
                        device=device), 0)


class ClipOCRNet(nn.Module):
    def __init__(self, encoder: nn.Module, num_class: int, fc_dim: int = 2048,
                 clipocr_all: bool = False):
        super().__init__()
        self.encoder = encoder
        self.num_class = num_class
        self.clipocr_all = clipocr_all
        self.conv_3x3 = conv_3x3(fc_dim)
        self.dsn_head = dsn_head(fc_dim // 2, num_class)
        self.spatial_ocr_head = SpatialOCR(512, 256, 512, dropout=0.05)
        self.head = Conv(512, num_class, 1)

    def _encode(self, img, valid_hw=None):
        """[N, 3, H, W] → (OCR features [N, 512, h, w], DSN logits, the
        features' valid size or None).  ``valid_hw``: the true size of
        width-bucketed zero-padded ``img`` (eval only, under inference
        mode): the trunk and both heads' 3x3 convs run under the
        spatial-conv-input mask, and the features' band is re-zeroed."""
        if valid_hw is None:
            conv_out = self.encoder(img)
            return (self.conv_3x3(conv_out[-1]), self.dsn_head(conv_out[-2]),
                    None)
        pad_hw = img.shape[-2:]
        with masked_trunk([self.encoder, self.dsn_head, self.conv_3x3],
                          valid_hw, pad_hw):
            conv_out = self.encoder(img)
            x_dsn = self.dsn_head(conv_out[-2])
            feat = self.conv_3x3(conv_out[-1])
        fv = feature_valid(*feat.shape[-2:], valid_hw, pad_hw)
        return mask_valid(feat, fv), x_dsn, fv

    def encode_frame(self, img, valid_hw=None):
        """One frame → (OCR features, region context [B, 512, K, 1]): the
        streaming cache.  Bucketed (``valid_hw``), the features are zero
        beyond their valid size and the gather excludes the band, so the
        context equals the unpadded run's."""
        feat, x_dsn, fv = self._encode(img, valid_hw)
        return feat, spatial_gather(feat, x_dsn, valid=fv)

    def fuse_target(self, target_feat, context):
        """OCR attention of the target's features against the blended
        region context → logits [B, K, h, w]."""
        return self.head(self.spatial_ocr_head(target_feat, context))

    def forward(self, imgs, memory=None, valid_hw=None):
        """imgs [T+1, B, 3, H, W], target LAST.  Training mode: (main
        logits, DSN logits over all frames [(T+1)*B, K, h, w]); eval mode:
        (main,), or ((main,), new memory) with ``memory`` (each frame's
        context pushed into the ring in order, then the valid entries
        averaged).  ``valid_hw``: the true size of width-bucketed
        zero-padded ``imgs`` (eval only): the masked encode, and the fuse on
        the padded grid (the OCR chain past the gather is per pixel)."""
        t1, b = imgs.shape[:2]
        feat, x_dsn, fv = self._encode(imgs.flatten(0, 1), valid_hw)
        ctx_frames = spatial_gather(feat, x_dsn, valid=fv).unflatten(
            0, (t1, b))                                # [T+1, B, C, K, 1]
        new_memory = None
        if memory is not None:
            buf, count = memory
            m = buf.shape[0]
            for i in range(t1):
                buf = torch.cat([buf[1:], ctx_frames[i:i + 1].float()])
                count = min(count + 1, m)
            context = (buf[m - count:].sum(0) / max(count, 1)).to(feat.dtype)
            new_memory = (buf, count)
        else:
            context = ctx_frames.float().mean(0).to(feat.dtype)
        if self.clipocr_all:
            x = self.fuse_target(feat, context.repeat(t1, 1, 1, 1))
            if not self.training:
                x = x.unflatten(0, (t1, b))[-1]
        else:
            x = self.fuse_target(feat.unflatten(0, (t1, b))[-1], context)
        if self.training:
            return x, x_dsn
        return ((x,), new_memory) if memory is not None else (x,)


def clip_ocr_loss(outs, batch, deep_sup_scale: float | None = 0.4,
                  clipocr_all: bool = False):
    """Training loss → (loss, acc) (reference clip_ocr.py:141-198).
    ``batch["labels"]``: [T+1, B, H, W], target last.  The reference order
    (log_softmax at feature resolution, bilinear upsample, NLL) in its
    projected form; the DSN term over all T+1 frames."""
    main, dsn = outs
    labels = batch["labels"]
    all_label = labels.flatten(0, 1)
    label = all_label if clipocr_all else labels[-1]
    loss = upsampled_logprob_loss_projected(main, label)
    if deep_sup_scale is not None:
        loss = loss + deep_sup_scale * upsampled_logprob_loss_projected(
            dsn, all_label)
    return loss, pixel_accuracy(main, label)


def build_clip_ocr(cfg, num_class: int,
                   clipocr_all: bool = False) -> ClipOCRNet:
    return ClipOCRNet(build_encoder(cfg.MODEL.arch_encoder), num_class,
                      fc_dim=cfg.MODEL.fc_dim, clipocr_all=clipocr_all)

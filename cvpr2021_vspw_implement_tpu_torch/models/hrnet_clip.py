"""HRNetV2-clip: early temporal fusion with ``TimeAtten`` (JAX counterpart:
models/hrnet_clip.py; reference models/hrnet_clip.py:26-519 and
``SegmentationModule_clip``, models/models.py:478-510).

The clip frames pass the stem (the two stride-2 convs and ``layer1``) with
frozen BatchNorm statistics and no gradient, before the target frame's pass
(reference hrnet_clip.py:443-453); with ``clip_middle`` the target's stem
output is fused with a cosine-similarity-softmax-weighted sum of the clip
frames' (``TimeAtten``) before the HRNet stages.  State-dict names are the
HRNet trunk's plus ``time_atten.conv1``, which the JAX package's
``import_hrnet_clip_state_dict`` reads.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..ops.interpolate import resize_bilinear
from ..ops.masked import (feature_valid, global_avg_pool_rt, mask_valid,
                          masked_trunk)
from ..utils.metrics import pixel_acc
from .hrnet import HRNetV2
from .layers import Conv, log_softmax
from .segmentation import nll_from_logprobs


def pool_valid(v, feat_valid=None):
    """[N, C, H, W] → [N, C]: the mean over the valid region ``feat_valid``
    (the whole map when None), the band re-zeroed in place first (B6),
    since the stem's output carries values there."""
    if feat_valid is None:
        return v.float().mean(dim=(2, 3))
    return global_avg_pool_rt(mask_valid(v, feat_valid).float(), feat_valid,
                              keepdim=False)


class TimeAtten(nn.Module):
    """Cosine-similarity-weighted clip fusion (reference hrnet_clip.py:
    26-60): the pooled target and clip features, each over its L2 norm plus
    1e-12, their dot products softmaxed over the frames, the clip features
    summed with those weights and divided by T once more (the reference's
    mean after the weighting), concatenated to the target's and fused by a
    biased 1x1 ``conv1``."""

    def __init__(self, dim: int = 256):
        super().__init__()
        self.conv1 = Conv(2 * dim, dim, 1)

    def weights(self, c_emb, clip_embs, feat_valid=None):
        """The blend weights [T, B]: the softmax over the frames of the
        cosine similarities of the pooled maps.  ``feat_valid``: the true
        size of the maps in width-bucketed eval (under inference mode):
        their bands are re-zeroed in place (B6) and the pooling averages
        over the valid region only."""
        t, b = clip_embs.shape[:2]
        q = pool_valid(c_emb, feat_valid)                    # [B, C]
        q = q / (q.norm(dim=1, keepdim=True) + 1e-12)
        ks = pool_valid(clip_embs.flatten(0, 1), feat_valid).reshape(
            t, b, -1)                                        # [T, B, C]
        ks = ks / (ks.norm(dim=2, keepdim=True) + 1e-12)
        return torch.softmax(torch.einsum("bc,tbc->tb", q, ks), dim=0)

    def forward(self, c_emb, clip_embs, feat_valid=None):
        """c_emb [B, C, H, W], clip_embs [T, B, C, H, W] → [B, C, H, W];
        ``feat_valid`` as :meth:`weights` takes it (the rest is per
        pixel)."""
        w = self.weights(c_emb, clip_embs, feat_valid)
        blended = torch.einsum("tb,tbchw->bchw", w, clip_embs.float())
        blended = blended / clip_embs.shape[0]
        return self.conv1(torch.cat([c_emb, blended.to(c_emb.dtype)], 1))


class HRNetV2Clip(HRNetV2):
    """The HRNetV2-W48 trunk of a target frame, its stem output fused with
    its clip frames' by ``TimeAtten`` when ``clip_middle``."""

    def __init__(self, clip_middle: bool = True):
        super().__init__()
        self.clip_middle = clip_middle
        self.time_atten = TimeAtten(256)

    def _frozen_stem(self, x):
        """The stem with its BatchNorms on their running statistics and no
        gradient, whatever the module's mode (JAX hrnet_clip.py:88-90)."""
        norms = [m for m in (self.bn1, self.bn2, *self.layer1.modules())
                 if isinstance(m, nn.BatchNorm2d)]
        modes = [m.training for m in norms]
        for m in norms:
            m.train(False)
        try:
            with torch.no_grad():
                return self.stem(x)
        finally:
            for m, mode in zip(norms, modes):
                m.train(mode)

    def forward(self, c_img, clip_imgs, valid_hw=None):
        """c_img [B, 3, H, W], clip_imgs [T, B, 3, H, W] → [the 720-channel
        map at output stride 4].

        ``valid_hw``: the true (rows, cols) of the frames inside a
        width-bucketed zero-padded grid (eval only, under inference mode):
        the trunk runs under the spatial-conv-input mask, TimeAtten pools
        the valid region, the fusion upsamples take the true sizes, and the
        output's band is re-zeroed (B6)."""
        t, b = clip_imgs.shape[:2]
        pad_hw = tuple(c_img.shape[-2:])
        ctx = (masked_trunk(self, valid_hw, pad_hw) if valid_hw is not None
               else contextlib.nullcontext())
        with ctx:
            # the clip frames first, as in JAX: the target's training pass
            # then updates the running statistics they were normalised by
            clip_feat = self._frozen_stem(clip_imgs.flatten(0, 1))
            clip_feat = clip_feat.reshape(t, b, *clip_feat.shape[1:])
            x = self.stem(c_img)
            if self.clip_middle:
                fv = (None if valid_hw is None else
                      feature_valid(*x.shape[-2:], valid_hw, pad_hw))
                x = self.time_atten(x, clip_feat, fv)
            out = self.stages(x, valid_hw, pad_hw)
        if valid_hw is not None:
            out = mask_valid(out, feature_valid(*out.shape[-2:], valid_hw,
                                                pad_hw))
        return [out]


class SegmentationModuleClip(nn.Module):
    """Clip encoder + per-frame decoder (reference models/models.py:
    478-510).  It takes the port's window convention, imgs [T+1, B, 3, H,
    W] with the target last, and gives the encoder (imgs[-1], imgs[:-1]),
    as the JAX CLI calls its model (JAX test_clip.py:255-259)."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder

    def forward(self, imgs, valid_hw=None):
        conv_out = self.encoder(imgs[-1], imgs[:-1], valid_hw=valid_hw)
        if valid_hw is None:
            return self.decoder(conv_out)
        fv = feature_valid(*conv_out[-1].shape[-2:], valid_hw,
                           imgs.shape[-2:])
        return self.decoder(conv_out, valid_hw=fv)


def seg_clip_loss(outs, batch, **_):
    """The target frame's loss and accuracy (reference models/models.py:
    487-503): log_softmax, bilinear resize to the label, NLL with 255
    ignored, and the accuracy of those log-probabilities.
    ``batch["labels"]``: [T+1, B, H, W], target last (the context labels
    are unused)."""
    label = batch["labels"][-1]
    logp = resize_bilinear(log_softmax(outs[0]), label.shape[-2:])
    return (nll_from_logprobs(logp, label),
            pixel_acc(logp.detach(), torch.where(label == 255, -1, label)))

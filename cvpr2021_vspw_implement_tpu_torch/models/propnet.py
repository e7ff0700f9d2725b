"""PropNet: label propagation by local minimum-distance matching (JAX
counterpart: models/propnet.py; reference models/propnet.py:19-267).

For each context frame, the per-frame head's hard labels are propagated to
the target: for every target pixel and every class, the score is the
smallest sigmoid-squashed embedding distance to a window position of the
context frame that carries the class (1.0 where none does).  The class map
is concatenated with the target's embedding and refined by a stack of
separable convs (``SegBlock``); inference means the per-frame SegBlock
logits with the per-frame head's logits on the target.

Only the eval forward is ported; training is refused.  The parameter names
are the reference's (``emb.{0,1}``, ``emb2.{0,1}``, ``last_layer.1``,
``segblock.conv{1-4}.{conv1,bn1,conv2,bn2}``, ``segblock.last_layer``), so
a ``state_dict()`` reads back through the JAX package's
``import_propnet_state_dict``.  No TPU kernel is involved: the JAX package
leaves the class-masked window minimum to XLA, and the port computes it
with one ``scatter_reduce`` (:func:`prop_pred`).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.interpolate import resize_nearest
from ..ops.local_pairwise import local_pairwise_dist, local_window_gather
from ..ops.masked import feature_mask, masked_encode
from .decoders import PPMDeepsupClip
from .layers import BatchNorm2d, Conv, ConvBNReLU, Dropout2d
from .resnet import build_encoder
from .warp_our import _int_list, training_not_ported


def prop_pred(prev_emb, query_emb, prev_labels, max_distance: int,
              num_class: int, feat_valid=None) -> torch.Tensor:
    """Propagated per-class minimum-distance map (reference
    propnet.py:54-81): prev_emb, query_emb [B, C, h, w]; prev_labels
    [B, H, W] (resized to h x w, nearest) → [B, num_class, h, w] in
    [-1, 1], 1 where the class is absent from the window.

    The reference masks a [B, h, w, k^2, num_class] volume and takes its
    minimum, which eager PyTorch would make in full (1.4 GB a context frame
    at 60x107 and r = 10).  Here the squashed distances [B, k^2, h*w] are
    scattered into [B, num_class + 1, h*w] bins, initialised to 1.0, by
    their labels with ``amin``; the window's padding (label -1) goes to the
    extra bin, which is dropped.  A minimum does not depend on order: the
    result is exact.

    ``feat_valid``: the valid (rows, cols) in width-bucketed eval.  Window
    positions beyond it get distance 1e20, which squashes to 1.0, the
    absent score, whatever label the band carries."""
    b, _, h, w = prev_emb.shape
    d = local_pairwise_dist(query_emb, prev_emb, max_distance,
                            valid_hw=feat_valid)
    d = (torch.sigmoid(d) - 0.5) * 2.0                    # [B, k, k, h, w]
    labels = resize_nearest(prev_labels[:, None].float(), (h, w))
    lwin = local_window_gather(labels, max_distance, pad_value=-1.0)
    idx = lwin.flatten(1, 3).flatten(2).long()            # [B, k^2, h*w]
    idx = torch.where(idx < 0, num_class, idx)
    out = torch.ones(b, num_class + 1, h * w, device=d.device)
    out.scatter_reduce_(1, idx, d.flatten(1, 2).flatten(2), "amin",
                        include_self=True)
    return out[:, :num_class].unflatten(2, (h, w))


class SplitSeparableConv(nn.Sequential):
    """Depthwise kxk + BN + ReLU, then pointwise 1x1 + BN + ReLU
    (reference propnet.py:84-103)."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 7):
        super().__init__()
        self.conv1 = nn.Conv2d(in_dim, in_dim, kernel_size,
                               padding=(kernel_size - 1) // 2, groups=in_dim)
        self.bn1 = BatchNorm2d(in_dim)
        self.relu1 = nn.ReLU(inplace=True)
        self.conv2 = Conv(in_dim, out_dim, 1)
        self.bn2 = BatchNorm2d(out_dim)
        self.relu2 = nn.ReLU(inplace=True)


class SegBlock(nn.Sequential):
    """Four separable convs and the classifier over [target embedding |
    propagated class map]."""

    def __init__(self, num_class: int, emb_dim: int = 256):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i + 1}", SplitSeparableConv(
                emb_dim + (num_class if i == 0 else 0), emb_dim))
        self.last_layer = Conv(emb_dim, num_class, 1)


class PropNet(nn.Module):
    def __init__(self, encoder: nn.Module, num_class: int,
                 fc_dim: int = 2048, emb_dim: int = 256,
                 max_distance: int = 10):
        super().__init__()
        self.num_class = num_class
        self.max_distance = max_distance
        self.encoder = encoder
        self.decoder = PPMDeepsupClip(num_class, fc_dim)
        self.emb = ConvBNReLU(512, emb_dim)
        self.emb2 = ConvBNReLU(512, emb_dim)
        self.last_layer = nn.Sequential(Dropout2d(0.1),
                                        Conv(emb_dim, num_class, 1))
        self.segblock = SegBlock(num_class, emb_dim)

    def forward(self, imgs, valid_hw=None):
        """imgs [T+1, B, 3, H, W], target LAST → (logits [B, K, h, w],).

        ``valid_hw``: the true (rows, cols) of width-bucketed zero-padded
        ``imgs`` (under inference mode): the masked trunk, each level
        re-zeroed, the decoder on C5's valid region, the heads masked at
        the feature level, and :func:`prop_pred` over the valid region
        (JAX models/propnet.py:99-188)."""
        if self.training:
            raise NotImplementedError(training_not_ported("propnet"))
        t1, b = imgs.shape[:2]
        conv_out, fv = masked_encode(self.encoder, imgs.flatten(0, 1),
                                     valid_hw)
        _, clip_embs, _ = self.decoder(conv_out, fv)
        with feature_mask((self.emb, self.emb2, self.segblock), fv,
                          clip_embs.shape[-2:]):
            ps = self.last_layer(self.emb(clip_embs)).unflatten(0, (t1, b))
            e2 = self.emb2(clip_embs).unflatten(0, (t1, b))
            out = [ps[-1]]
            for f in range(t1 - 1):
                prop = prop_pred(e2[f], e2[-1], ps[f].argmax(1),
                                 self.max_distance, self.num_class, fv)
                out.append(self.segblock(torch.cat([e2[-1], prop], 1)))
        return (torch.stack(out, 0).mean(0),)


def build_propnet(cfg, num_class: int, args) -> PropNet:
    """PropNet reads the first of ``--max_distances``."""
    return PropNet(build_encoder(cfg.MODEL.arch_encoder), num_class,
                   fc_dim=cfg.MODEL.fc_dim, max_distance=_int_list(
                       getattr(args, "max_distances", [10]))[0])

"""PropNet: label propagation by local minimum-distance matching (JAX
counterpart: models/propnet.py; reference models/propnet.py:19-267).

For each context frame, the per-frame head's hard labels are propagated to
the target: for every target pixel and every class, the score is the
smallest sigmoid-squashed embedding distance to a window position of the
context frame that carries the class (1.0 where none does).  The class map
is concatenated with the target's embedding and refined by a stack of
separable convs (``SegBlock``); inference means the per-frame SegBlock
logits with the per-frame head's logits on the target.

Training (JAX models/propnet.py:158-219) propagates hard labels taken from
the per-frame head's log-probabilities upsampled to the frame's size and
returns each context frame's SegBlock logits beside the per-frame head and
the deep supervision.  The distances stay plain PyTorch in training as in
eval: the gradient reaches the embeddings through ``scatter_reduce``'s
``amin``, which splits it evenly among tied minima as JAX's ``min`` does.
The parameter names are the reference's (``emb.{0,1}``, ``emb2.{0,1}``,
``last_layer.1``, ``segblock.conv{1-4}.{conv1,bn1,conv2,bn2}``,
``segblock.last_layer``), so a ``state_dict()`` reads back through the JAX
package's ``import_propnet_state_dict``.  No TPU kernel is involved: the
JAX package leaves the class-masked window minimum to XLA, and the port
computes it with one ``scatter_reduce`` (:func:`prop_pred`).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.interpolate import resize_bilinear, resize_nearest
from ..ops.local_pairwise import local_pairwise_dist, local_window_gather
from ..ops.masked import feature_mask, masked_encode
from .decoders import PPMDeepsupClip
from .layers import BatchNorm2d, Conv, ConvBNReLU, Dropout2d, log_softmax
from .resnet import build_encoder
from .segmentation import pixel_accuracy, upsampled_logprob_loss_projected
from .warp_our import _int_list


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
    out = d.new_ones(b, num_class + 1, h * w)
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
        """imgs [T+1, B, 3, H, W], target LAST → (logits [B, K, h, w],),
        or in training {"pred_s": the per-frame head [(T+1)*B, K, h, w],
        "deepsup": [(T+1)*B, K, h, w], "preds_c": each context frame's
        SegBlock logits [B, K, h, w]}.

        ``valid_hw``: the true (rows, cols) of width-bucketed zero-padded
        ``imgs`` (under inference mode): the masked trunk, each level
        re-zeroed, the decoder on C5's valid region, the heads masked at
        the feature level, and :func:`prop_pred` over the valid region
        (JAX models/propnet.py:99-188)."""
        t1, b = imgs.shape[:2]
        conv_out, fv = masked_encode(self.encoder, imgs.flatten(0, 1),
                                     valid_hw)
        deepsup, clip_embs, _ = self.decoder(conv_out, fv)
        if self.training:
            pred_s = self.last_layer(self.emb(clip_embs))
            e2 = self.emb2(clip_embs).unflatten(0, (t1, b))
            # the per-frame hard labels at the frames' size (JAX
            # propnet.py:158-172); prop_pred resizes them to the features
            with torch.no_grad():
                labels = resize_bilinear(log_softmax(pred_s),
                                         imgs.shape[-2:]).argmax(1)
            labels = labels.unflatten(0, (t1, b))
            preds_c = [self.segblock(torch.cat([e2[-1], prop_pred(
                e2[f], e2[-1], labels[f], self.max_distance,
                self.num_class)], 1)) for f in range(t1 - 1)]
            return {"pred_s": pred_s, "deepsup": deepsup, "preds_c": preds_c}
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


def propnet_loss(outs, batch, deep_sup_scale: float | None = 0.4,
                 allsup_scale: float = 0.3):
    """Training loss → (loss, acc) (JAX models/propnet.py:191-219;
    reference propnet.py:186-237): the mean NLL of the context frames'
    SegBlock logits on the target, plus the per-frame head's and (scaled)
    the deep supervision's on every frame, scaled by ``allsup_scale``."""
    labels = batch["labels"]
    label = labels[-1]
    all_label = labels.flatten(0, 1)
    loss_a = upsampled_logprob_loss_projected(outs["pred_s"], all_label)
    if deep_sup_scale is not None:
        loss_a = (loss_a + deep_sup_scale * upsampled_logprob_loss_projected(
            outs["deepsup"], all_label)) * allsup_scale
    losses = [upsampled_logprob_loss_projected(p, label)
              for p in outs["preds_c"]]
    loss = sum(losses) / len(losses) + loss_a
    return loss, pixel_accuracy(outs["preds_c"][-1], label)


def build_propnet(cfg, num_class: int, args) -> PropNet:
    """PropNet reads the first of ``--max_distances``."""
    return PropNet(build_encoder(cfg.MODEL.arch_encoder), num_class,
                   fc_dim=cfg.MODEL.fc_dim, max_distance=_int_list(
                       getattr(args, "max_distances", [10]))[0])

"""The per-frame model, training losses and inference heads (JAX
counterpart: models/segmentation.py).

``SegmentationModule`` is encoder + decoder (reference models/models.py:
74-111), returning the decoder's logits.  The reference's training-loss
order is log_softmax at FEATURE resolution, bilinear upsample of the
log-probabilities to the label size, then NLL with ignore index 255
(models/models.py:954-957, 96-104).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.interpolate import linear_weights, resize_bilinear
from ..ops.masked import masked_encode, resize_bilinear_rt
from ..utils.metrics import pixel_acc
from .layers import log_softmax


class SegmentationModule(nn.Module):
    """Encoder + decoder: [N, 3, H, W] normalized → the decoder's tuple of
    logits, (main,) in eval and (main, deep supervision) in training for
    the ``*deepsup`` heads.

    ``valid_hw``: the true (rows, cols) of the image inside a zero-padded
    width bucket (eval only, under inference mode; ops/masked.py): the
    trunk runs under the spatial-conv-input mask, every level's band is
    re-zeroed in place (B6) and the decoder gets C5's valid size, or, for a
    head that spans strides (``spans_strides``: UPerNet's FPN levels,
    DeepLab's OS8 and OS4), the input's valid and padded sizes, from which
    it derives each level's (JAX models/segmentation.py:55-62); so the
    logits' valid region is the unpadded run's."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder

    def forward(self, img, valid_hw=None):
        conv_out, fv = masked_encode(self.encoder, img, valid_hw)
        if fv is None:
            return self.decoder(conv_out)
        if getattr(self.decoder, "spans_strides", False):
            return self.decoder(conv_out, valid_hw=valid_hw,
                                pad_hw=tuple(img.shape[-2:]))
        return self.decoder(conv_out, valid_hw=fv)


def nll_from_logprobs(logp: torch.Tensor, label: torch.Tensor,
                      ignore_index: int = 255) -> torch.Tensor:
    """torch ``NLLLoss(ignore_index)`` on log-probabilities [N, K, H, W]
    and labels [N, H, W]: mean over the non-ignored pixels."""
    valid = label != ignore_index
    lab = torch.where(valid, label, 0).long()
    picked = torch.gather(logp.float(), 1, lab[:, None])[:, 0]
    return -(picked * valid).sum() / valid.sum().clamp(min=1)


def upsampled_logprob_loss(logits: torch.Tensor,
                           label: torch.Tensor) -> torch.Tensor:
    """The reference order as written: log_softmax, resize, NLL."""
    logp = resize_bilinear(log_softmax(logits), label.shape[1:3])
    return nll_from_logprobs(logp, label)


def upsampled_logprob_loss_projected(logits: torch.Tensor,
                                     label: torch.Tensor) -> torch.Tensor:
    """``upsampled_logprob_loss`` by the transpose trick:

        -<onehot_valid, Rh logp Rw^T>/N  ==  -<Rh^T onehot_valid Rw, logp>/N

    (the separable resize is linear).  Equal within f32 reassociation, but
    the [N, K, H, W] full-resolution log-prob volume (114 MB per 479x479
    image at K = 124, once more for its gradient) is never made: the one-hot
    mask is projected down to the feature grid instead, and the backward is
    a product with that constant."""
    b, k, fh, fw = logits.shape
    h, w = label.shape[1:3]
    logp = log_softmax(logits)
    rh = torch.from_numpy(linear_weights(fh, h)).to(logits.device)  # [H, fh]
    rw = torch.from_numpy(linear_weights(fw, w)).to(logits.device)  # [W, fw]
    valid = label != 255
    lab = torch.where(valid, label, 0).long()
    onehot = torch.zeros(b, h, w, k, device=logits.device)
    onehot.scatter_(3, lab[..., None], valid[..., None].float())
    m = torch.einsum("hf,bhwk->bfwk", rh, onehot)
    m = torch.einsum("wg,bfwk->bkfg", rw, m)              # [b, k, fh, fw]
    return -(m * logp).sum() / valid.sum().clamp(min=1)


def pixel_accuracy(logits: torch.Tensor, label: torch.Tensor):
    """Accuracy of the argmax of ``logits`` upsampled to ``label``'s size,
    255 ignored (the argmax of the upsampled log-probabilities, which the
    JAX losses take, is the same)."""
    up = resize_bilinear(logits.detach().float(), label.shape[1:3])
    return pixel_acc(up, torch.where(label == 255, -1, label))


def segmentation_loss(outputs, label: torch.Tensor,
                      deep_sup_scale: float | None = 0.4):
    """(loss, acc) of the per-frame model (reference models/models.py:
    82-108): the projected NLL of the main logits plus ``deep_sup_scale``
    times that of the deep-supervision logits when there are some; the
    accuracy of the main logits upsampled to ``label`` [N, H, W] (255
    ignored)."""
    loss = upsampled_logprob_loss_projected(outputs[0], label)
    if deep_sup_scale is not None and len(outputs) > 1:
        loss = loss + deep_sup_scale * upsampled_logprob_loss_projected(
            outputs[1], label)
    return loss, pixel_accuracy(outputs[0], label)


def inference_pred(outputs, seg_size, align_corners: bool = False):
    """Argmax prediction at ``seg_size``: logits [N, K, h, w] (or a tuple
    whose first item they are) → [N, H, W] uint8.  Equal to the argmax of
    the upsampled softmax (softmax is monotone; reference test.py:66-70)."""
    logits = outputs[0] if isinstance(outputs, (tuple, list)) else outputs
    x = resize_bilinear(logits.float(), seg_size, align_corners=align_corners)
    return torch.argmax(x, dim=1).to(torch.uint8)


def inference_probs(outputs, seg_size) -> torch.Tensor:
    """Softmax probabilities [N, K, H, W] of the logits upsampled to
    ``seg_size`` (reference models/models.py:109-111): what nonlocal3d's
    ``test_all`` averages over windows."""
    logits = outputs[0] if isinstance(outputs, (tuple, list)) else outputs
    return torch.softmax(resize_bilinear(logits.float(), seg_size), dim=1)


def inference_probs_rt(outputs, seg_pad, feat_valid,
                       seg_valid) -> torch.Tensor:
    """``inference_probs`` for width-bucketed eval, on the padded grid
    ``seg_pad``; beyond ``seg_valid`` garbage that the caller crops."""
    logits = outputs[0] if isinstance(outputs, (tuple, list)) else outputs
    x = resize_bilinear_rt(logits.float(), seg_pad, feat_valid, seg_valid)
    return torch.softmax(x, dim=1)


def inference_pred_rt(outputs, seg_pad, feat_valid, seg_valid,
                      align_corners: bool = False):
    """``inference_pred`` for width-bucketed eval: the logits' valid region
    ``feat_valid`` resized to the true output size ``seg_valid`` on the
    padded grid ``seg_pad`` (ops/masked.py), then the argmax.  Rows and
    columns beyond ``seg_valid`` are garbage: the caller crops."""
    logits = outputs[0] if isinstance(outputs, (tuple, list)) else outputs
    x = resize_bilinear_rt(logits.float(), seg_pad, feat_valid, seg_valid,
                           align_corners=align_corners)
    return torch.argmax(x, dim=1).to(torch.uint8)

"""Training losses and inference heads (JAX counterpart:
models/segmentation.py).

The reference's training-loss order is log_softmax at FEATURE resolution,
bilinear upsample of the log-probabilities to the label size, then NLL with
ignore index 255 (models/models.py:954-957, 96-104).
"""

from __future__ import annotations

import torch

from ..ops.interpolate import linear_weights, resize_bilinear
from ..ops.masked import resize_bilinear_rt
from ..utils.metrics import pixel_acc
from .layers import log_softmax


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


def inference_pred(outputs, seg_size, align_corners: bool = False):
    """Argmax prediction at ``seg_size``: logits [N, K, h, w] (or a tuple
    whose first item they are) → [N, H, W] uint8.  Equal to the argmax of
    the upsampled softmax (softmax is monotone; reference test.py:66-70)."""
    logits = outputs[0] if isinstance(outputs, (tuple, list)) else outputs
    x = resize_bilinear(logits.float(), seg_size, align_corners=align_corners)
    return torch.argmax(x, dim=1).to(torch.uint8)


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

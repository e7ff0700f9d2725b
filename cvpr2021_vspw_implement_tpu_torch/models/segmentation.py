"""Inference heads (JAX counterpart: models/segmentation.py)."""

from __future__ import annotations

import torch

from ..ops.interpolate import resize_bilinear


def inference_pred(outputs, seg_size, align_corners: bool = False):
    """Argmax prediction at ``seg_size``: logits [N, K, h, w] (or a tuple
    whose first item they are) → [N, H, W] uint8.  Equal to the argmax of
    the upsampled softmax (softmax is monotone; reference test.py:66-70)."""
    logits = outputs[0] if isinstance(outputs, (tuple, list)) else outputs
    x = resize_bilinear(logits.float(), seg_size, align_corners=align_corners)
    return torch.argmax(x, dim=1).to(torch.uint8)

"""RAFT all-pairs correlation pyramid and its window lookup (JAX
counterpart: models/raft/corr.py; reference RAFT_core/corr.py:12-60).

The correlation ``<f1, f2> / sqrt(C)`` is one batched matrix product; the
4-level pyramid average-pools the second image's dims; the lookup (the
hand-written kernel of ``ops/corr_lookup.py``) samples a (2r+1)^2 window
around each pixel's current correspondence on every level.
"""

from __future__ import annotations

import math

import torch

from ...ops.corr_lookup import lookup_corr_pyramid

__all__ = ["all_pairs_correlation", "build_corr_pyramid",
           "lookup_corr_pyramid"]


def all_pairs_correlation(fmap1: torch.Tensor,
                          fmap2: torch.Tensor) -> torch.Tensor:
    """fmap1/fmap2 [B, C, H, W] → corr [B, H*W, H, W] (f32)."""
    b, c, h, w = fmap1.shape
    f1 = fmap1.reshape(b, c, h * w).float()
    f2 = fmap2.reshape(b, c, h * w).float()
    corr = torch.matmul(f1.transpose(1, 2), f2) / math.sqrt(c)
    return corr.reshape(b, h * w, h, w)


def build_corr_pyramid(fmap1, fmap2, num_levels: int = 4):
    """Levels [B, P, Hl, Wl], each the 2x2 average pool (floor) of the
    last; a level may be empty when the features are small."""
    corr = all_pairs_correlation(fmap1, fmap2)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        b, p, h, w = corr.shape
        h2, w2 = h // 2, w // 2
        corr = corr[:, :, :h2 * 2, :w2 * 2].reshape(b, p, h2, 2, w2, 2)
        corr = corr.mean(dim=(3, 5))
        pyramid.append(corr)
    return pyramid

"""Local squared-distance cost volumes and window aggregation, plain PyTorch
(JAX counterpart: ops/local_pairwise.py; reference models/warp_our.py:20-50).

For every pixel p of x and every position q of a (2r+1)^2 window around p
in y (dy the outer offset, dx the inner one):

    dist(p, q) = |x_p|^2 + |y_q|^2 - 2 <x_p, y_q>

with the reference's padding: outside the image y is 0 and |y|^2 is 1e20.
Tensors are NCHW; the window axes come right after the batch:
``dist`` and ``weights`` are [B, k, k, H, W], k = 2r + 1.  Each (dy, dx)
offset is one shifted elementwise product, so nothing of size
[B, C, k^2, H, W] is formed except by :func:`local_window_gather`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: |y|^2 of a window position outside the image (the reference's pad value)
OUT_OF_IMAGE = 1e20


def valid_region(t: torch.Tensor, valid_hw) -> torch.Tensor:
    """[H, W] bool mask of the top-left ``valid_hw`` of ``t``'s grid."""
    inside = torch.zeros(t.shape[-2:], dtype=torch.bool, device=t.device)
    inside[:int(valid_hw[0]), :int(valid_hw[1])] = True
    return inside


def local_pairwise_dist(x: torch.Tensor, y: torch.Tensor, r: int,
                        valid_hw=None) -> torch.Tensor:
    """x, y [B, C, H, W] → dist [B, k, k, H, W] (float32; float64 for
    float64 inputs, the backward's second witness on the card).

    ``valid_hw``: the true (rows, cols) of the maps inside a width-bucketed
    buffer.  Positions of y at or beyond it get y = 0 and |y|^2 = 1e20, as
    the unpadded run treats positions beyond its edge, so the distances on
    the valid region are the unpadded run's (the argmax order that
    ``distnearest`` relies on included)."""
    b, _, h, w = x.shape
    k = 2 * r + 1
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, yf = x.to(ct), y.to(ct)
    if valid_hw is not None:
        inside = valid_region(y, valid_hw)
        yf = torch.where(inside, yf, 0.0)
    x2 = xf.square().sum(1)                                   # [B, H, W]
    y2 = yf.square().sum(1)
    if valid_hw is not None:
        y2 = torch.where(inside, y2, OUT_OF_IMAGE)
    y_pad = F.pad(yf, (r, r, r, r))
    y2_pad = F.pad(y2, (r, r, r, r), value=OUT_OF_IMAGE)
    rows = []
    for dy in range(k):
        cols = []
        for dx in range(k):
            dot = (xf * y_pad[:, :, dy:dy + h, dx:dx + w]).sum(1)
            cols.append(x2 + y2_pad[:, dy:dy + h, dx:dx + w] - 2.0 * dot)
        rows.append(torch.stack(cols, 1))
    return torch.stack(rows, 1)


def local_weighted_aggregate(y: torch.Tensor, weights: torch.Tensor,
                             r: int) -> torch.Tensor:
    """sum over the window of weights[:, dy, dx] * y[h+dy-r, w+dx-r] (0
    outside the image); y [B, C, H, W], weights [B, k, k, H, W] →
    [B, C, H, W]."""
    b, c, h, w = y.shape
    k = 2 * r + 1
    y_pad = F.pad(y.float(), (r, r, r, r))
    wf = weights.float()
    out = torch.zeros(b, c, h, w, dtype=torch.float32, device=y.device)
    for dy in range(k):
        for dx in range(k):
            out += wf[:, None, dy, dx] * y_pad[:, :, dy:dy + h, dx:dx + w]
    return out.to(y.dtype)


def local_window_gather(y: torch.Tensor, r: int,
                        pad_value: float = 0.0) -> torch.Tensor:
    """y [B, C, H, W] → windows [B, C, k, k, H, W] (``pad_value`` outside
    the image), window order as in :func:`local_pairwise_dist`."""
    h, w = y.shape[-2:]
    k = 2 * r + 1
    y_pad = F.pad(y, (r, r, r, r), value=pad_value)
    return torch.stack([
        torch.stack([y_pad[:, :, dy:dy + h, dx:dx + w] for dx in range(k)], 2)
        for dy in range(k)], 2)

"""Grid sampling and optical-flow warping of NCHW tensors (JAX counterpart:
ops/warp.py).

``flowwarp`` keeps the reference's mixed convention (utils.py:10-35): the
sampling grid is normalized by (dim-1), as for ``align_corners=True``, and
then sampled with ``align_corners=False`` and zero padding.  There is no
kernel here: ``F.grid_sample`` is the whole operation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(x: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                align_corners: bool = False) -> torch.Tensor:
    """x [N, C, H, W]; grid [N, Ho, Wo, 2] normalized (gx, gy) in [-1, 1]."""
    return F.grid_sample(x, grid, mode=mode, padding_mode="zeros",
                         align_corners=align_corners)


def flowwarp(x: torch.Tensor, flow: torch.Tensor, mode: str = "bilinear",
             valid_hw=None) -> torch.Tensor:
    """Warp x [N, C, H, W] by flow [N, 2, H, W] (fx, fy) in pixels.

    ``valid_hw``: the true (rows, cols) of x and flow inside a
    width-bucketed padded grid (ops/masked.py).  The grid is normalised by
    the true (dim - 1) and only x's valid region is sampled, so taps beyond
    it read zeros as the unpadded run's out-of-range taps do; the output
    keeps the padded size, its band is garbage for the caller to crop."""
    n, _, h, w = flow.shape
    if valid_hw is not None:
        x = x[..., :valid_hw[0], :valid_hw[1]]
    vh, vw = x.shape[-2:]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=x.device),
        torch.arange(w, dtype=torch.float32, device=x.device), indexing="ij")
    vx = xs + flow[:, 0].float()
    vy = ys + flow[:, 1].float()
    gx = 2.0 * vx / max(vw - 1, 1) - 1.0
    gy = 2.0 * vy / max(vh - 1, 1) - 1.0
    return grid_sample(x, torch.stack([gx, gy], dim=-1), mode=mode,
                       align_corners=False)

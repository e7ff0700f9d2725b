"""RAFT optical flow, test-mode forward (JAX counterpart:
models/raft/raft.py; reference RAFT_core/raft.py:26-127).

A frozen flow estimator for the TC metric: feature and context encoders,
a 4-level all-pairs correlation pyramid, ``iters`` refinements of a
separable ConvGRU, and convex 8x upsampling.  The mask head runs once,
after the loop: only the last iteration's mask is used in test mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.masked import (feature_valid, mask_valid, mask_valid_hw2,
                           masked_trunk)
from .corr import build_corr_pyramid, lookup_corr_pyramid
from .extractor import BasicEncoder
from .update import BasicUpdateBlock


def coords_grid(batch: int, ht: int, wd: int, device=None) -> torch.Tensor:
    """[B, 2, H, W] (x, y) pixel coordinate grid (utils.py:76-79)."""
    ys, xs = torch.meshgrid(torch.arange(ht, dtype=torch.float32,
                                         device=device),
                            torch.arange(wd, dtype=torch.float32,
                                         device=device), indexing="ij")
    return torch.stack([xs, ys], 0)[None].expand(batch, -1, -1, -1).clone()


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor):
    """Convex-combination 8x upsampling (reference raft.py:61-72): flow
    [N, 2, H, W]; mask [N, 576, H, W] laid out (9, 8, 8) with the 3x3 taps
    outer and in ``F.unfold`` order."""
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)


class RAFT(nn.Module):
    """Images in [0, 255], NCHW; ``forward`` returns (flow_low, flow_up)."""

    def __init__(self, iters: int = 12, corr_levels: int = 4,
                 corr_radius: int = 4, hidden_dim: int = 128,
                 context_dim: int = 128):
        super().__init__()
        self.iters = iters
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.hidden_dim = hidden_dim
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(hidden_dim + context_dim, "batch")
        self.update_block = BasicUpdateBlock(hidden_dim, corr_levels,
                                             corr_radius)

    def forward(self, image1, image2, valid_hw=None):
        """``valid_hw``: the true (rows, cols), a multiple of 8, of the
        images inside a width-bucketed zero-padded grid (eval only, under
        inference mode).  Both encoders and the update block then run under
        the spatial-conv-input mask with masked InstanceNorm statistics and
        GRU carries, every pyramid level is masked to its valid extent, and
        so is the flow before the convex upsample (ops/masked.py): the
        flow's valid region equals the unpadded run's."""
        if valid_hw is None:
            return self._forward(image1, image2, None)
        pad_hw = image1.shape[-2:]
        with masked_trunk(self, valid_hw, pad_hw):
            return self._forward(image1, image2, (valid_hw, pad_hw))

    def _forward(self, image1, image2, mask):
        image1 = 2 * (image1 / 255.0) - 1.0
        image2 = 2 * (image2 / 255.0) - 1.0
        fmap1, fmap2 = self.fnet(torch.cat([image1, image2], 0)).chunk(2, 0)
        pyramid = build_corr_pyramid(fmap1, fmap2, self.corr_levels)
        if mask is not None:
            # each level's valid extent is floor(prev / 2), as the unpadded
            # pooling drops the odd tail; windows straddling the boundary
            # must read zeros, as the unpadded run's out-of-range taps do
            lv = feature_valid(*fmap1.shape[-2:], *mask)
            for lev in pyramid:
                mask_valid_hw2(lev, lv)
                lv = (lv[0] // 2, lv[1] // 2)

        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = torch.relu(cnet[:, self.hidden_dim:])

        b, _, h8, w8 = fmap1.shape
        coords0 = coords_grid(b, h8, w8, image1.device)
        coords1 = coords0
        taps = self.update_block.taps()
        for _ in range(self.iters):
            corr = lookup_corr_pyramid(pyramid, coords1.contiguous(),
                                       self.corr_radius)
            net, delta = self.update_block(net, inp, corr, coords1 - coords0,
                                           taps)
            coords1 = coords1 + delta
        flow_low = coords1 - coords0
        if mask is not None:
            # the convex upsample's 3x3 taps at the boundary must read zeros
            mask_valid(flow_low, feature_valid(*flow_low.shape[-2:], *mask))
        flow_up = upsample_flow_convex(flow_low,
                                       self.update_block.upsample_mask(net))
        return flow_low, flow_up


def pad_to_multiple_of_8(x: torch.Tensor):
    """Symmetric ('sintel') InputPadder geometry (reference
    RAFT_core/utils/utils.py:7-25) with the JAX package's zero padding.
    x [B, C, H, W] → (padded, (top, bottom, left, right))."""
    h, w = x.shape[-2:]
    pad_h = (((h // 8) + 1) * 8 - h) % 8
    pad_w = (((w // 8) + 1) * 8 - w) % 8
    pads = (pad_h // 2, pad_h - pad_h // 2, pad_w // 2, pad_w - pad_w // 2)
    t, bt, l, r = pads
    return F.pad(x, (l, r, t, bt)), pads


def unpad(x: torch.Tensor, pads) -> torch.Tensor:
    t, b, l, r = pads
    h, w = x.shape[-2:]
    return x[..., t:h - b, l:w - r]


def bucketed_flow(raft: RAFT, image1, image2, valid_hw):
    """RAFT flow of a width-bucketed pair at the reference's /8 geometry
    (JAX ``NetWarp._flow_masked`` and ``tc_cal.step_bucketed``).  image1 /
    image2 [N, 3, Hp, Wp] in [0, 255], zero beyond the true size
    ``valid_hw``.  The reference pads symmetrically to a multiple of 8
    (``pad_to_multiple_of_8``), and stride-2 convs are not shift-covariant,
    so the images roll to that pad's (top, left) offset inside the bucket,
    the masked RAFT runs to the /8-aligned extent, and the flow rolls back:
    its [N, 2, Hp, Wp] valid region equals the exact-shape run's up to the
    order of f32 sums; beyond it the values are garbage for the caller to
    crop or re-zero.  (-h) % 8 <= (-h) % 32, so the bucket's slack holds the
    pad (``ops/masked.py::bucket_hw``)."""
    h, w = valid_hw
    pad_h = (((h // 8) + 1) * 8 - h) % 8
    pad_w = (((w // 8) + 1) * 8 - w) % 8
    top, left = pad_h // 2, pad_w // 2
    _, flow = raft(torch.roll(image1, (top, left), (2, 3)),
                   torch.roll(image2, (top, left), (2, 3)),
                   valid_hw=(h + pad_h, w + pad_w))
    return torch.roll(flow, (-top, -left), (2, 3))


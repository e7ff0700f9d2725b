"""The generic non-local block and the Non-local 2D decoder (JAX
counterpart: models/nonlocal_blocks.py ``NLBlockND``, ``NonLocal2d``;
reference models/non_local.py:7-151, models/non_local_models.py:115-151).

Positions (T)HW are flattened, so the pairwise function is one batched
product [N, P, P] whatever the number of spatial dims.  The four pairwise
modes: ``gaussian`` and ``embedded`` take a softmax over the keys, ``dot``
and ``concatenate`` divide by the number of positions.  The products keep
the JAX order, ``(theta^T phi) / P`` then ``@ g``: re-associating them
changes the rounding.  The residual branch ends in a BatchNorm whose scale
starts at zero, so at init the block is the identity.

The layers are the reference's (``g``, ``theta``, ``phi``, ``W_f.0``,
``W_z.{0,1}``: 1x1 convs and a BatchNorm of the block's dimension), so a
reference checkpoint loads as it is and the JAX importers read the port's
``state_dict()``; the 1x1 convs run as products over the flattened
positions.  The residual BatchNorm keeps its zero scale through
``layers.init_weights`` (``keep_init``), as the JAX block's does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masked import mask_valid
from .layers import Conv

_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}
_BN = {1: nn.BatchNorm1d, 2: nn.BatchNorm2d, 3: nn.BatchNorm3d}
MODES = ("gaussian", "embedded", "dot", "concatenate")


def _project(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv on positions [N, C, P] → [N, C', P]."""
    w = conv.weight.reshape(conv.weight.shape[0], -1)
    return torch.matmul(w, x) + conv.bias[:, None]


def true_positions(spatial, valid_hw) -> int:
    """The number of valid positions of a [..., h, w] grid whose last two
    dims are valid up to ``valid_hw``: the dot and concatenate modes'
    normaliser in width-bucketed eval."""
    return math.prod(spatial[:-2]) * int(valid_hw[0]) * int(valid_hw[1])


class NLBlockND(nn.Module):
    """x [N, C, *spatial] → the same shape (``dimension`` spatial dims)."""

    def __init__(self, in_channels: int, inter_channels: int | None = None,
                 mode: str = "embedded", dimension: int = 3,
                 bn_layer: bool = True):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}")
        self.mode = mode
        self.in_channels = in_channels
        self.inter_channels = inter_channels or max(in_channels // 2, 1)
        conv, inter = _CONV[dimension], self.inter_channels
        self.g = conv(in_channels, inter, 1)
        if mode != "gaussian":
            self.theta = conv(in_channels, inter, 1)
            self.phi = conv(in_channels, inter, 1)
        if mode == "concatenate":
            self.W_f = nn.Sequential(nn.Conv2d(2 * inter, 1, 1), nn.ReLU())
        if bn_layer:
            self.W_z = nn.Sequential(conv(inter, in_channels, 1),
                                     _BN[dimension](in_channels))
            nn.init.zeros_(self.W_z[1].weight)
            nn.init.zeros_(self.W_z[1].bias)
            self.W_z[1].keep_init = True
        else:
            self.W_z = conv(inter, in_channels, 1)
            nn.init.zeros_(self.W_z.weight)
            nn.init.zeros_(self.W_z.bias)

    def pairwise(self, flat: torch.Tensor) -> torch.Tensor:
        """The pairwise function f [N, P, P] of positions [N, C, P]."""
        if self.mode == "gaussian":
            x = flat.float()
            return torch.matmul(x.transpose(1, 2), x)
        theta = _project(self.theta, flat).float()
        phi = _project(self.phi, flat).float()
        if self.mode != "concatenate":
            return torch.matmul(theta.transpose(1, 2), phi)
        n, inter, p = theta.shape
        tp = theta.transpose(1, 2)[:, :, None].expand(n, p, p, inter)
        ph = phi.transpose(1, 2)[:, None].expand(n, p, p, inter)
        cat = torch.cat([tp, ph], dim=-1)
        wf = self.W_f[0]
        return F.relu(torch.matmul(cat, wf.weight.reshape(1, -1).t())
                      + wf.bias)[..., 0].float()

    def forward(self, x: torch.Tensor, valid_hw=None) -> torch.Tensor:
        """``valid_hw``: in width-bucketed eval, the valid (rows, cols) of
        the last two spatial dims of a zero-masked padded ``x``.  Padded
        keys are excluded from the attention (-inf before the softmax
        modes, 0 in the others, which divide by the true position count),
        so the valid region equals the unpadded run's; the padded queries'
        rows are garbage that the caller never reads."""
        n, c = x.shape[:2]
        spatial = x.shape[2:]
        flat = x.reshape(n, c, -1)
        p = flat.shape[-1]
        g_x = _project(self.g, flat).float().transpose(1, 2)    # [N, P, inter]
        f = self.pairwise(flat)
        if valid_hw is not None:
            keep = torch.zeros(spatial[-2:], dtype=torch.bool, device=x.device)
            keep[:int(valid_hw[0]), :int(valid_hw[1])] = True
            keep = keep.expand(spatial).reshape(p)
            f = torch.where(keep, f, float("-inf") if self.mode in (
                "gaussian", "embedded") else 0.0)
        if self.mode in ("gaussian", "embedded"):
            f_div = torch.softmax(f, dim=-1)
        else:
            f_div = f / (p if valid_hw is None
                         else true_positions(spatial, valid_hw))
        y = torch.matmul(f_div, g_x).to(x.dtype)                # [N, P, inter]
        y = y.transpose(1, 2).reshape(n, self.inter_channels, *spatial)
        return self.W_z(y) + x


class NonLocal2d(nn.Module):
    """The Non-local 2D decoder (reference models/non_local_models.py:
    115-151): C5 embedded to 256 channels by a 1x1 conv, a 2D ``NLBlockND``
    in ``dot`` mode over it, the two concatenated and classified by a 1x1
    conv.  Returns (logits,).  Module names are the reference's (``emb``,
    ``nonlocalblock``, ``last_layer``), which the JAX package's
    ``import_nonlocal2d_decoder_state_dict`` reads.

    Width-bucketed eval (``valid_hw``: C5's valid size): the embedding's
    band (its conv's bias) is re-zeroed (B6) and the block excludes the
    padded keys, dividing by the true position count; the other convs are
    1x1, so the valid region is the unpadded run's."""

    def __init__(self, num_class: int = 150, fc_dim: int = 2048):
        super().__init__()
        self.emb = Conv(fc_dim, 256, 1)
        self.nonlocalblock = NLBlockND(256, mode="dot", dimension=2)
        self.last_layer = Conv(512, num_class, 1)

    def forward(self, conv_out, valid_hw=None):
        emb = self.emb(conv_out[-1])
        if valid_hw is not None:
            emb = mask_valid(emb, valid_hw)
        nl = self.nonlocalblock(emb, valid_hw=valid_hw)
        return (self.last_layer(torch.cat([emb, nl], 1)),)

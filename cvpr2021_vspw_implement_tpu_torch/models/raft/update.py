"""RAFT update block: motion encoder, separable ConvGRU, flow and mask
heads (JAX counterpart: models/raft/update.py; reference
RAFT_core/update.py).

The GRU's two passes go through the hand-written kernel of
``ops/sep_gru.py`` (the TPU kernel's counterpart); the motion encoder and
the heads stay ``F.conv2d``, as the JAX package runs them above 4096
positions.  The mask head is a separate method so the driver computes it
once after the loop.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.sep_gru import sep_conv_gru_pass


class FlowHead(nn.Module):
    def __init__(self, input_dim=128, hidden_dim=256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        return self.conv2(self.relu(self.conv1(x)))


def _taps(convs):
    """Conv2d weights [cout, cin, 1, 5] or [cout, cin, 5, 1] of several
    convs → one [5, cin, sum(cout)] kernel and its bias."""
    w = torch.cat([c.weight for c in convs], 0)
    w = w.reshape(w.shape[0], w.shape[1], -1).permute(2, 1, 0).contiguous()
    return w, torch.cat([c.bias for c in convs], 0)


class SepConvGRU(nn.Module):
    """Two-pass (1x5 then 5x1) gated recurrent unit (update.py:33-60)."""

    def __init__(self, hidden_dim=128, input_dim=192 + 128):
        super().__init__()
        cin = hidden_dim + input_dim
        for i, k in ((1, (1, 5)), (2, (5, 1))):
            pad = (k[0] // 2, k[1] // 2)
            for g in "zrq":
                self.add_module(f"conv{g}{i}",
                                nn.Conv2d(cin, hidden_dim, k, padding=pad))

    def forward(self, h, x):
        for axis, i in ((0, 1), (1, 2)):
            wzr, bzr = _taps([getattr(self, f"convz{i}"),
                              getattr(self, f"convr{i}")])
            wq, bq = _taps([getattr(self, f"convq{i}")])
            h = sep_conv_gru_pass(h, x, wzr, bzr, wq, bq, axis)
        return h


class BasicMotionEncoder(nn.Module):
    """corr + flow → 128-d motion features (update.py:80-97)."""

    def __init__(self, corr_levels=4, corr_radius=4):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, flow, corr):
        cor = self.relu(self.convc2(self.relu(self.convc1(corr))))
        flo = self.relu(self.convf2(self.relu(self.convf1(flow))))
        out = self.relu(self.conv(torch.cat([cor, flo], 1)))
        return torch.cat([out, flow], 1)


class BasicUpdateBlock(nn.Module):
    def __init__(self, hidden_dim=128, corr_levels=4, corr_radius=4):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(nn.Conv2d(hidden_dim, 256, 3, padding=1),
                                  nn.ReLU(inplace=True),
                                  nn.Conv2d(256, 64 * 9, 1))

    def upsample_mask(self, net):
        """Convex-upsampling mask (scaled by 0.25 as the reference)."""
        return 0.25 * self.mask(net)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], 1))
        return net, self.flow_head(net)

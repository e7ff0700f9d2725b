"""RAFT update block: motion encoder, separable ConvGRU, flow and mask
heads (JAX counterpart: models/raft/update.py; reference
RAFT_core/update.py).

Up to ``FUSED_MAX_POSITIONS`` feature positions an iteration is two
hand-written kernels: ``ops/motion_encoder.py`` and ``ops/gru_flowhead.py``.
Above it, and always under a width-bucket mask (ops/masked.py), the GRU's
two passes go through the kernel of ``ops/sep_gru.py`` and the motion
encoder and the flow head stay ``F.conv2d``: the fused chains do not
re-mask between their convs.  The mask head is a separate method so RAFT
computes it once after the loop.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.gru_flowhead import gru_flowhead
from ...ops.masked import current_mask, mask_current
from ...ops.motion_encoder import conv_taps, motion_encoder
from ...ops.sep_gru import sep_conv_gru_pass

#: the largest H*W (feature positions) that takes the fused kernels.  Mirrors
#: the JAX dispatch (models/raft/update.py:185-189), which keeps RAFT at the
#: 479 training crop (60x60) on the fused pair and the TC metric's 480x853
#: frames (60x107) on the row-tiled GRU pass.
FUSED_MAX_POSITIONS = 4096


class FlowHead(nn.Module):
    def __init__(self, input_dim=128, hidden_dim=256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        return self.conv2(self.relu(self.conv1(x)))


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

    def taps(self):
        """{"zr1", "q1", "zr2", "q2"}: each pass's fused z|r kernel and its
        q kernel as ([5, cin, cout], bias)."""
        out = {}
        for i in (1, 2):
            out[f"zr{i}"] = conv_taps([getattr(self, f"convz{i}"),
                                       getattr(self, f"convr{i}")])
            out[f"q{i}"] = conv_taps([getattr(self, f"convq{i}")])
        return out

    def forward(self, h, x, taps):
        """Both passes.  Under a width-bucket mask the 5-tap gates would
        carry band values into the valid region: x is re-zeroed once, h
        before each pass and at the end (in place, the JAX masked
        function)."""
        x = mask_current(x)
        for axis, i in ((0, 1), (1, 2)):
            h = sep_conv_gru_pass(mask_current(h), x, *taps[f"zr{i}"],
                                  *taps[f"q{i}"], axis)
        return mask_current(h)


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

    def taps(self):
        """Every conv of an iteration in the kernels' [taps, cin, cout]
        layout: ``{"encoder": ..., "gru": ...}`` as ``ops/motion_encoder.py``
        and ``ops/gru_flowhead.py`` take them.  The weights are the same for
        all refinements, so RAFT packs them once per forward."""
        enc = {name: conv_taps([getattr(self.encoder, name)])
               for name in ("convc1", "convc2", "convf1", "convf2", "conv")}
        gru = self.gru.taps()
        gru["fh_conv1"] = conv_taps([self.flow_head.conv1])
        gru["fh_conv2"] = conv_taps([self.flow_head.conv2])
        return {"encoder": enc, "gru": gru}

    def forward(self, net, inp, corr, flow, taps):
        """One refinement → (net', delta_flow); ``taps`` from
        :meth:`taps`."""
        if (current_mask() is None
                and net.shape[2] * net.shape[3] <= FUSED_MAX_POSITIONS):
            motion = motion_encoder(corr, flow.contiguous(), taps["encoder"])
            return gru_flowhead(net, torch.cat([inp, motion], 1), taps["gru"])
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], 1), taps["gru"])
        return net, self.flow_head(net)

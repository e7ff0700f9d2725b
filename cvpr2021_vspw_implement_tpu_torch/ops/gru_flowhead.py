"""RAFT's SepConvGRU (both passes) and flow head as one call: the CUDA
kernel and its plain version (JAX counterparts: ops/pallas/raft_update.py::
gru_flowhead_fused and gru_flowhead_xla).

    for the 1x5 pass, then the 5x1 pass:
        z|r = sigmoid(conv([h | x]) + bzr);  q = tanh(conv([r*h | x]) + bq)
        h   = (1 - z) * h + z * q
    delta = conv2(relu(conv1(h)))                   3x3 then 3x3, 2 channels

Tensors are NCHW.  ``weights`` maps ``zr1``, ``q1`` (1x5 pass), ``zr2``,
``q2`` (5x1 pass), ``fh_conv1`` and ``fh_conv2`` to ``(w, bias)`` with w
[taps, cin, cout] (tap row-major, input channel, output channel).
"""

from __future__ import annotations

import torch

from .. import kernels
from .motion_encoder import tap_conv_plain
from .sep_gru import sep_conv_gru_pass_plain

CONVS = ("zr1", "q1", "zr2", "q2", "fh_conv1", "fh_conv2")


def gru_flowhead_plain(net, x, weights):
    """``F.conv2d`` formulation; net [B, hd, H, W], x [B, cx, H, W] →
    (net' [B, hd, H, W], delta [B, 2, H, W])."""
    for axis, i in ((0, 1), (1, 2)):
        net = sep_conv_gru_pass_plain(net, x, *weights[f"zr{i}"],
                                      *weights[f"q{i}"], axis)
    hidden = torch.relu(tap_conv_plain(net, *weights["fh_conv1"]))
    return net, tap_conv_plain(hidden, *weights["fh_conv2"])


def gru_flowhead_flops(b: int, h: int, w: int, hd: int, cx: int,
                       cf: int) -> int:
    """f32 operations of one call: the two GRU passes' 5-tap products and
    the flow head's two 3x3 convolutions, 2 per multiply-add."""
    return 2 * b * h * w * (2 * 5 * (hd + cx) * 3 * hd + 9 * hd * cf
                            + 9 * cf * 2)


def gru_flowhead(net, x, weights):
    """The layout of :func:`gru_flowhead_plain`.  A CPU tensor takes the
    plain version; a CUDA tensor launches ``kernels/csrc/gru_flowhead.cu``
    (six launches behind one C entry point; the GRU and the flow head's
    first conv on the tensor cores at f32 accuracy: 3xTF32)."""
    if net.device.type == "cpu":
        return gru_flowhead_plain(net, x, weights)
    if net.device.type != "cuda":
        raise RuntimeError(f"no GRU + flow head for device {net.device}")
    b, hd, hh, ww = net.shape
    cx = x.shape[1]
    cin = hd + cx
    cf = weights["fh_conv1"][0].shape[2]
    shapes = {"zr1": (5, cin, 2 * hd), "q1": (5, cin, hd),
              "zr2": (5, cin, 2 * hd), "q2": (5, cin, hd),
              "fh_conv1": (9, hd, cf), "fh_conv2": (9, cf, 2)}
    if x.shape != (b, cx, hh, ww) or hd % 32 or cf % 4 or cf > 512:
        # a 32-channel K step of the GRU convolutions reads one input: h or x
        raise ValueError("the GRU + flow-head kernel takes net [B, hd, H, W], "
                         "x [B, cx, H, W], hd a multiple of 32 and a "
                         "flow-head width that is a multiple of 4, at most "
                         "512")
    flat = []
    for name in CONVS:
        w, bias = weights[name]
        if w.shape != shapes[name] or bias.shape != shapes[name][2:]:
            raise ValueError(f"{name}: weights must be {list(shapes[name])} "
                             f"with a [{shapes[name][2]}] bias")
        flat += [w, bias]
    kernels.check_inputs("gru_flowhead", (net, x, *flat))
    kernels.check_aligned("gru_flowhead", flat[:10:2])
    scratch = torch.empty(b * (3 * hd + cf) * hh * ww, device=net.device)
    net_out = torch.empty_like(net)
    delta = torch.empty(b, 2, hh, ww, device=net.device)
    kernels.check(kernels.entry("gru_flowhead_f32")(
        net.data_ptr(), x.data_ptr(), *[t.data_ptr() for t in flat],
        scratch.data_ptr(), net_out.data_ptr(), delta.data_ptr(), b, hh, ww,
        hd, cx, cf, kernels.stream(net.get_device())),
        "gru_flowhead_f32")
    gru_flowhead.launches += 1
    gru_flowhead.flops += gru_flowhead_flops(b, hh, ww, hd, cx, cf)
    return net_out, delta


#: the kernel's launches, and their f32 operations
#: (:func:`gru_flowhead_flops`)
gru_flowhead.launches = 0
gru_flowhead.flops = 0

"""One separable ConvGRU pass: the CUDA kernel and its plain version (JAX
counterparts: ops/pallas/gru.py::sep_conv_gru_pass and
sep_conv_gru_pass_xla).

    z|r = sigmoid(conv([h | x]) + bzr);  q = tanh(conv([r*h | x]) + bq)
    h'  = (1 - z) * h + z * q

with a 5-tap convolution along W (``axis=0``, the 1x5 pass) or along H
(``axis=1``, the 5x1 pass).  Tensors are NCHW; weights are
[taps, hd + cx, cout] (tap, input channel, output channel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels


def _conv(inp, w, bias, axis: int):
    taps = w.shape[0]
    k = w.permute(2, 1, 0)                               # [cout, cin, taps]
    k = k[:, :, None, :] if axis == 0 else k[:, :, :, None]
    pad = (0, taps // 2) if axis == 0 else (taps // 2, 0)
    return F.conv2d(inp, k, bias, padding=pad)


def sep_conv_gru_pass_plain(h, x, wzr, bzr, wq, bq, axis: int):
    """``F.conv2d`` formulation of one pass; h [B, hd, H, W], x [B, cx, H, W]."""
    hd = h.shape[1]
    zr = torch.sigmoid(_conv(torch.cat([h, x], 1), wzr, bzr, axis))
    z, r = zr[:, :hd], zr[:, hd:]
    q = torch.tanh(_conv(torch.cat([r * h, x], 1), wq, bq, axis))
    return (1 - z) * h + z * q


def sep_conv_gru_pass_flops(b: int, h: int, w: int, hd: int, cx: int) -> int:
    """f32 operations of one pass: its two 5-tap products (z|r, then q)
    over hd + cx input channels, 2 per multiply-add."""
    return 2 * b * h * w * 5 * (hd + cx) * 3 * hd


def sep_conv_gru_pass(h, x, wzr, bzr, wq, bq, axis: int):
    """One pass, the layout of :func:`sep_conv_gru_pass_plain`.  A CPU
    tensor takes the plain version; a CUDA tensor launches
    ``kernels/csrc/sep_gru.cu`` (gate, then q and blend, on the tensor cores
    at f32 accuracy: 3xTF32)."""
    if h.device.type == "cpu":
        return sep_conv_gru_pass_plain(h, x, wzr, bzr, wq, bq, axis)
    if h.device.type != "cuda":
        raise RuntimeError(f"no GRU pass for device {h.device}")
    b, hd, hh, ww = h.shape
    cx = x.shape[1]
    cin = hd + cx
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if (x.shape != (b, cx, hh, ww)
            or wzr.shape != (5, cin, 2 * hd) or wq.shape != (5, cin, hd)
            or bzr.shape != (2 * hd,) or bq.shape != (hd,)):
        raise ValueError("the GRU kernel takes h [B, hd, H, W], x [B, cx, H, "
                         "W] and 5-tap weights [5, hd+cx, cout]")
    if hd % 32:
        # a 32-channel K step of the kernel reads one input: h or x
        raise ValueError(f"the GRU kernel takes hd a multiple of 32, got {hd}")
    kernels.check_inputs("sep_conv_gru_pass", (h, x, wzr, bzr, wq, bq))
    kernels.check_aligned("sep_conv_gru_pass", (wzr, wq))
    z = torch.empty_like(h)
    rh = torch.empty_like(h)
    out = torch.empty_like(h)
    kernels.check(kernels.entry("sep_gru_pass_f32")(
        h.data_ptr(), x.data_ptr(), wzr.data_ptr(), bzr.data_ptr(),
        wq.data_ptr(), bq.data_ptr(), z.data_ptr(), rh.data_ptr(),
        out.data_ptr(), b, hh, ww, hd, cx, axis,
        kernels.stream(h.get_device())), "sep_gru_pass_f32")
    sep_conv_gru_pass.launches += 1
    sep_conv_gru_pass.flops += sep_conv_gru_pass_flops(b, hh, ww, hd, cx)
    return out


#: the kernel's launches, and their f32 operations
#: (:func:`sep_conv_gru_pass_flops`)
sep_conv_gru_pass.launches = 0
sep_conv_gru_pass.flops = 0

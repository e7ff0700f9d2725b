"""RAFT's motion encoder as one call: the CUDA kernel and its plain version
(JAX counterparts: ops/pallas/raft_update.py::motion_encoder_fused and
motion_encoder_xla).

    cor = relu(convc2(relu(convc1(corr))))          1x1 then 3x3
    flo = relu(convf2(relu(convf1(flow))))          7x7 then 3x3
    out = cat(relu(conv(cat(cor, flo))), flow)      3x3, 126 + 2 channels

Tensors are NCHW.  ``weights`` maps each conv's name (``convc1``, ``convc2``,
``convf1``, ``convf2``, ``conv``) to ``(w, bias)`` with w [taps, cin, cout]
(tap row-major, input channel, output channel).
"""

from __future__ import annotations

import math
import weakref

import torch
import torch.nn.functional as F

from .. import kernels

CONVS = ("convc1", "convc2", "convf1", "convf2", "conv")
# (taps, cin, cout) of each conv for ck correlation channels
_CHANNELS = {"convc1": (1, None, 256), "convc2": (9, 256, 192),
             "convf1": (49, 2, 128), "convf2": (9, 128, 64),
             "conv": (9, 256, 126)}


def conv_taps(convs):
    """``nn.Conv2d`` weights [cout, cin, kh, kw] of several convs over one
    input → one [kh*kw, cin, sum(cout)] kernel and its bias."""
    w = torch.cat([c.weight for c in convs], 0)
    w = w.reshape(w.shape[0], w.shape[1], -1).permute(2, 1, 0).contiguous()
    return w, torch.cat([c.bias for c in convs], 0)


def tap_conv_plain(x, w, bias):
    """``F.conv2d`` with a square [k*k, cin, cout] kernel, zero padded to
    the input's size."""
    taps, cin, cout = w.shape
    k = math.isqrt(taps)
    return F.conv2d(x, w.permute(2, 1, 0).reshape(cout, cin, k, k), bias,
                    padding=k // 2)


def motion_encoder_plain(corr, flow, weights):
    """``F.conv2d`` formulation; corr [B, ck, H, W], flow [B, 2, H, W] →
    [B, 128, H, W]."""
    def c(x, name):
        return torch.relu(tap_conv_plain(x, *weights[name]))

    cor = c(c(corr, "convc1"), "convc2")
    flo = c(c(flow, "convf1"), "convf2")
    return torch.cat([c(torch.cat([cor, flo], 1), "conv"), flow], 1)


def _version(t):
    """In-place writes bump a tensor's version; an inference tensor has
    none (None)."""
    return None if t.is_inference() else t._version


#: conv's weights padded to 128 output channels and the (w, bias) they came
#: from: (weakrefs, versions, padded pair)
_padded = None


def _padded_conv(w, bias):
    """conv's [9, 256, 126] weights and [126] bias with two zero output
    channels appended, as the kernel takes them (16-byte weight rows).  Made
    once and kept while the same (w, bias) live unmodified: RAFT packs its
    weights once a forward (``BasicUpdateBlock.taps``) and calls the encoder
    at every refinement."""
    global _padded
    versions = (_version(w), _version(bias))
    if (_padded is None or _padded[0][0]() is not w
            or _padded[0][1]() is not bias or _padded[1] != versions):
        pair = (F.pad(w, (0, 2)).contiguous(),
                F.pad(bias, (0, 2)).contiguous())
        _padded = ((weakref.ref(w), weakref.ref(bias)), versions, pair)
    return _padded[2]


def motion_encoder_flops(b: int, h: int, w: int, ck: int) -> int:
    """f32 operations of one call: its five convolutions, 2 per
    multiply-add (conv's 126 output channels, not the kernel's 128)."""
    per_position = sum(taps * (cin or ck) * cout
                       for taps, cin, cout in _CHANNELS.values())
    return 2 * b * h * w * per_position


def motion_encoder(corr, flow, weights):
    """The layout of :func:`motion_encoder_plain`.  A CPU tensor takes the
    plain version; a CUDA tensor launches ``kernels/csrc/motion_encoder.cu``
    (five launches behind one C entry point; convc1, convc2, convf2 and conv
    on the tensor cores at f32 accuracy: 3xTF32).  The kernel has no
    backward: while grad is enabled it refuses an operand that requires grad
    before any launch; the plain version stays differentiable."""
    if corr.device.type == "cpu":
        return motion_encoder_plain(corr, flow, weights)
    kernels.check_no_grad("motion-encoder", (
        corr, flow, *(t for pair in weights.values() for t in pair)))
    if corr.device.type != "cuda":
        raise RuntimeError(f"no motion encoder for device {corr.device}")
    b, ck, hh, ww = corr.shape
    if flow.shape != (b, 2, hh, ww):
        raise ValueError("the motion-encoder kernel takes corr [B, ck, H, W] "
                         "and flow [B, 2, H, W]")
    flat = []
    for name in CONVS:
        taps, cin, cout = _CHANNELS[name]
        w, bias = weights[name]
        if w.shape != (taps, cin or ck, cout) or bias.shape != (cout,):
            raise ValueError(f"{name}: weights must be [{taps}, {cin or ck}, "
                             f"{cout}] with a [{cout}] bias")
        flat += [w, bias]
    kernels.check_inputs("motion_encoder", (corr, flow, *flat))
    flat[8:10] = _padded_conv(*flat[8:10])
    kernels.check_aligned("motion_encoder", flat[0:4:2] + flat[6:10:2])
    scratch = torch.empty(b * 640 * hh * ww, device=corr.device)
    out = torch.empty(b, 128, hh, ww, device=corr.device)
    kernels.check(kernels.entry("motion_encoder_f32")(
        corr.data_ptr(), flow.data_ptr(), *[t.data_ptr() for t in flat],
        scratch.data_ptr(), out.data_ptr(), b, hh, ww, ck,
        kernels.stream(corr.get_device())),
        "motion_encoder_f32")
    motion_encoder.launches += 1
    motion_encoder.flops += motion_encoder_flops(b, hh, ww, ck)
    return out


#: the kernel's launches, and their f32 operations
#: (:func:`motion_encoder_flops`)
motion_encoder.launches = 0
motion_encoder.flops = 0

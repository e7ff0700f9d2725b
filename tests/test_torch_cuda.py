"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and imports no JAX, so it runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a card every test skips.  Tolerances: the corr lookup is the same
f32 arithmetic (atol 1e-5); the GRU pass, the motion encoder and the GRU +
flow head sum products of up to 2304 terms in another order than cuDNN, the
last two through chains of five and six convolutions, their convolutions
on the tensor cores at f32 accuracy (3xTF32, about 2^-22 of each product;
the motion encoder's 7x7 on the flow on the CUDA cores) (atol 1e-4).  The
local aggregations (B5) sum 128-term distances and up to 441 weighted
values in another order than the plain version, both products on the
tensor cores in 3xTF32 (sigmoid and softmax: atol 1e-5 and rtol 1e-4 per
element, and at most 1e-4 of the largest output overall, on the near-match
inputs of ``local_agg_inputs``, whose window weights are far from uniform
and whose softmax scores stay far from the pole of 1 / (dist * temp +
1e-5)); nearest must pick the same value except where the two largest
in-image window distances lie within 1e-4 relative.  With a valid size B5
writes zeros beyond it and its valid region is bitwise the launch on the
contiguous crop (no arithmetic of a valid position depends on the buffer's
size).  The band re-zero (B6) only stores zeros: bitwise equal.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(__file__))
import chip_smoke  # noqa: E402
from torch_port_util import (gru_flowhead_inputs, gru_inputs,  # noqa: E402
                             local_agg_inputs, motion_inputs, port_gru_args,
                             port_gru_flowhead_weights, port_motion_weights,
                             pyramid, query_coords, to_nchw, weights_to)
from cvpr2021_vspw_implement_tpu_torch.ops.corr_lookup import (  # noqa: E402
    lookup_corr_pyramid, lookup_corr_pyramid_plain)
from cvpr2021_vspw_implement_tpu_torch.ops import local_agg  # noqa: E402
from cvpr2021_vspw_implement_tpu_torch.ops.band_zero import (  # noqa: E402
    band_zero, band_zero_plain)
from cvpr2021_vspw_implement_tpu_torch.ops.gru_flowhead import (  # noqa: E402
    gru_flowhead, gru_flowhead_plain)
from cvpr2021_vspw_implement_tpu_torch.ops.local_pairwise import (  # noqa: E402
    local_pairwise_dist)
from cvpr2021_vspw_implement_tpu_torch.ops.motion_encoder import (  # noqa: E402
    motion_encoder, motion_encoder_plain)
from cvpr2021_vspw_implement_tpu_torch.ops.sep_gru import (  # noqa: E402
    sep_conv_gru_pass, sep_conv_gru_pass_plain)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_corr_lookup_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(2)
    levels = [torch.from_numpy(l).to(cuda_device)
              for l in pyramid(rng, 2, 15, 21)]
    coords = torch.from_numpy(np.moveaxis(query_coords(rng, 2, 15, 21), -1, 1)
                              .copy()).to(cuda_device)
    before = lookup_corr_pyramid.launches
    got = lookup_corr_pyramid(levels, coords)
    torch.cuda.synchronize()
    assert lookup_corr_pyramid.launches == before + 1
    torch.testing.assert_close(got, lookup_corr_pyramid_plain(levels, coords),
                               rtol=0, atol=1e-5)


def _lookup_case(device, seed, b, h, w, levels=4):
    """A seeded pyramid and coords as RAFT builds them (f1 . f2 / sqrt(256),
    2x2 average pooling), coords on the query grid plus N(0, 8^2) px."""
    from cvpr2021_vspw_implement_tpu_torch.models.raft.corr import \
        build_corr_pyramid
    g = torch.Generator(device=device).manual_seed(seed)
    f1, f2 = (torch.randn(b, 256, h, w, device=device, generator=g)
              for _ in range(2))
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    coords = torch.stack([xs, ys]).float()[None] + 8 * torch.randn(
        b, 2, h, w, device=device, generator=g)
    return build_corr_pyramid(f1, f2)[:levels], coords.contiguous()


def _check_lookup(levels, coords):
    before = lookup_corr_pyramid.launches
    got = lookup_corr_pyramid(levels, coords)
    torch.cuda.synchronize()
    assert lookup_corr_pyramid.launches == before + 1
    want = lookup_corr_pyramid_plain(levels, coords)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(1, 60, 107), (2, 60, 60)])
def test_corr_lookup_kernel_at_smoke_shapes(cuda_device, b, h, w):
    """The TC shape and the ETC train shape; at 1x60x107 level 3 is 7x13
    and at 60x60 7x7, both smaller than the 10x10 patch."""
    _check_lookup(*_lookup_case(cuda_device, 1, b, h, w))


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_corr_lookup_kernel_batch2_levels(cuda_device, levels):
    _check_lookup(*_lookup_case(cuda_device, 2, 2, 23, 41, levels))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(7, 7), (7, 13)])
def test_corr_lookup_kernel_level_smaller_than_patch(cuda_device, h, w):
    """Level 0 itself smaller than the patch (levels 1-3: 3x3 / 3x6, 1x1 /
    1x3, 0x0 / 0x1: empty levels read zero)."""
    rng = np.random.default_rng(h * w)
    levels = [torch.from_numpy(l).to(cuda_device)
              for l in pyramid(rng, 2, h, w)]
    coords = torch.from_numpy(np.moveaxis(query_coords(rng, 2, h, w), -1, 1)
                              .copy()).to(cuda_device)
    _check_lookup(levels, coords)


@pytest.mark.cuda
def test_corr_lookup_kernel_far_coords(cuda_device):
    """Coords of +-1e9 (x0 + 1 in int would overflow) and queries whose
    whole window lies outside every level: zeros, as the plain version."""
    levels, coords = _lookup_case(cuda_device, 3, 2, 20, 30)
    coords[0, 0, ::3] = 1e9
    coords[1, 1, 1::3] = -1e9
    coords[:, 0, 2::3] = -50.0                 # x0 - 4 + 9 < 0 on every level
    got = _check_lookup(levels, coords)
    assert not got[:, :, 2::3].any()


@pytest.mark.cuda
def test_corr_lookup_kernel_across_64px(cuda_device):
    """x coords from 56 to 72 px: c + d crosses 64, where f32 rounds it; each
    tap takes the fraction of its own c + d, as the plain version does (one
    fraction shared by a query's 9 taps lands more than 1e-5 away)."""
    levels, coords = _lookup_case(cuda_device, 5, 1, 16, 80)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    coords[:, 0] = 56.0 + 16.0 * torch.rand(1, 16, 80, device=cuda_device,
                                            generator=g)
    _check_lookup(levels, coords)


@pytest.mark.cuda
def test_corr_lookup_kernel_refuses_grad(cuda_device):
    """The kernel has no backward: the wrapper refuses, before any launch,
    coords or a level that require grad."""
    levels, coords = _lookup_case(cuda_device, 4, 1, 8, 12)
    before = lookup_corr_pyramid.launches
    with pytest.raises(ValueError, match="requires grad"):
        lookup_corr_pyramid(levels, coords.requires_grad_())
    with pytest.raises(ValueError, match="requires grad"):
        lookup_corr_pyramid([levels[0].requires_grad_(), *levels[1:]],
                            coords.detach())
    assert lookup_corr_pyramid.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(2, 11, 70), (1, 60, 107), (1, 60, 112)])
@pytest.mark.parametrize("axis", [0, 1])
def test_sep_gru_kernel_matches_plain(cuda_device, axis, b, h, w):
    """Also at both TC shapes: 60x107 (rows not 16-byte aligned: 4-byte
    copies) and the 60x112 bucket (aligned rows: 16-byte copies for dx = 0
    taps)."""
    rng = np.random.default_rng(3 + axis)
    args = [t.to(cuda_device)
            for t in port_gru_args(*gru_inputs(rng, b, h, w, 128, 256, axis))]
    before = sep_conv_gru_pass.launches
    got = sep_conv_gru_pass(*args, axis)
    torch.cuda.synchronize()
    assert sep_conv_gru_pass.launches == before + 1
    torch.testing.assert_close(got, sep_conv_gru_pass_plain(*args, axis),
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
def test_sep_gru_kernel_partial_channel_chunk(cuda_device, axis):
    """cx = 100: hd + cx = 228 input channels end in a partial K step of the
    tensor-core kernel, whose channels past 228 must be zero-filled."""
    rng = np.random.default_rng(9 + axis)
    args = [t.to(cuda_device)
            for t in port_gru_args(*gru_inputs(rng, 1, 13, 37, 128, 100, axis))]
    before = sep_conv_gru_pass.launches
    got = sep_conv_gru_pass(*args, axis)
    torch.cuda.synchronize()
    assert sep_conv_gru_pass.launches == before + 1
    torch.testing.assert_close(got, sep_conv_gru_pass_plain(*args, axis),
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
def test_sep_gru_kernel_matches_float64(cuda_device, axis):
    """At the TC shape the 3xTF32 products hold the pass within 1e-5 of a
    float64 reference; one TF32 product a term (no split) or tensor-core
    sums chained over K would not (see tests/test_torch_tf32_split.py)."""
    rng = np.random.default_rng(12 + axis)
    args = [t.to(cuda_device) for t in
            port_gru_args(*gru_inputs(rng, 1, 60, 107, 128, 256, axis))]
    want = sep_conv_gru_pass_plain(*[t.double() for t in args], axis)
    got = sep_conv_gru_pass(*args, axis)
    torch.cuda.synchronize()
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-5, err


def _update_cases(device):
    """(wrapper, its arguments, the tensors that may require grad) of B2,
    B3 and B4 at a small shape on ``device``."""
    rng = np.random.default_rng(13)
    gru = [t.to(device)
           for t in port_gru_args(*gru_inputs(rng, 1, 8, 12, 128, 64, 0))]
    corr, flow, enc = _motion_case(device, 14, 1, 8, 12)
    net, x, p = gru_flowhead_inputs(rng, 1, 8, 12)
    net, x = to_nchw(net).to(device), to_nchw(x).to(device)
    fh = weights_to(port_gru_flowhead_weights(p), device)
    return {"sep_gru": (sep_conv_gru_pass, (*gru, 0), gru[2]),
            "motion_encoder": (motion_encoder, (corr, flow, enc),
                               enc["convc1"][0]),
            "gru_flowhead": (gru_flowhead, (net, x, fh), fh["zr1"][0])}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sep_gru", "motion_encoder",
                                  "gru_flowhead"])
def test_update_kernels_refuse_grad(cuda_device, name):
    """B2-B4 have no backward: under grad, an activation or a weight that
    requires grad is refused before any launch; under no_grad, weights that
    keep requires_grad (tc_cal's RAFT) launch as before."""
    fn, args, weight = _update_cases(cuda_device)[name]
    before = fn.launches
    weight.requires_grad_()
    with pytest.raises(ValueError, match="requires grad"):
        fn(*args)
    weight.requires_grad_(False)
    act = args[0].clone().requires_grad_()
    with pytest.raises(ValueError, match="requires grad"):
        fn(act, *args[1:])
    assert fn.launches == before
    weight.requires_grad_()
    with torch.no_grad():
        fn(act, *args[1:])
    torch.cuda.synchronize()
    assert fn.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [36, 100])
def test_gru_kernels_refuse_hd_not_multiple_of_32(cuda_device, hd):
    """A 32-channel K step of the tensor-core kernel reads h or x, never
    both: both wrappers refuse such an hd before any launch."""
    rng = np.random.default_rng(11)
    args = [t.to(cuda_device)
            for t in port_gru_args(*gru_inputs(rng, 1, 8, 12, hd, 64, 0))]
    before = sep_conv_gru_pass.launches
    with pytest.raises(ValueError, match="multiple of 32"):
        sep_conv_gru_pass(*args, 0)
    assert sep_conv_gru_pass.launches == before
    net, x, p = gru_flowhead_inputs(rng, 1, 8, 12, hd=hd, cx=64)
    net, x = to_nchw(net).to(cuda_device), to_nchw(x).to(cuda_device)
    weights = weights_to(port_gru_flowhead_weights(p), cuda_device)
    before = gru_flowhead.launches
    with pytest.raises(ValueError, match="multiple of 32"):
        gru_flowhead(net, x, weights)
    assert gru_flowhead.launches == before


SHAPES = [(1, 37, 53), (2, 37, 53), (1, 60, 60), (2, 60, 60)]


def _motion_case(device, seed, b, h, w, ck=324):
    corr, flow, p = motion_inputs(np.random.default_rng(seed), b, h, w,
                                  ck=ck)
    return (to_nchw(corr).to(device), to_nchw(flow).to(device),
            weights_to(port_motion_weights(p), device))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", SHAPES + [(1, 60, 107)])
def test_motion_encoder_kernel_matches_plain(cuda_device, b, h, w):
    """Also at the TC shape 1x60x107 (rows not 16-byte aligned: 4-byte
    activation copies), which the model gates off this kernel (above 4096
    positions) but the wrapper takes.  The last two output channels are the
    input flow, bitwise: conv computes 128 channels from weights padded
    with zeros and stores 126."""
    corr, flow, weights = _motion_case(cuda_device, 5, b, h, w)
    before = motion_encoder.launches
    got = motion_encoder(corr, flow, weights)
    torch.cuda.synchronize()
    assert motion_encoder.launches == before + 1
    torch.testing.assert_close(got, motion_encoder_plain(corr, flow, weights),
                               rtol=0, atol=1e-4)
    assert torch.equal(got[:, 126:], flow)


@pytest.mark.cuda
@pytest.mark.parametrize("ck", [100, 324])
def test_motion_encoder_kernel_partial_channel_chunk(cuda_device, ck):
    """convc1's K = ck: 100 and 324 (10 x 32 + 4) end in a partial
    32-channel K step of the tensor-core kernel, zero-filled past ck."""
    corr, flow, weights = _motion_case(cuda_device, 8, 2, 13, 37, ck)
    got = motion_encoder(corr, flow, weights)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, motion_encoder_plain(corr, flow, weights),
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_motion_encoder_kernel_matches_float64(cuda_device):
    """At the ETC train shape the 3xTF32 products hold the encoder within
    1e-5 of a float64 evaluation."""
    corr, flow, weights = _motion_case(cuda_device, 13, 2, 60, 60)
    want = motion_encoder_plain(corr.double(), flow.double(), {
        k: (w.double(), b.double()) for k, (w, b) in weights.items()})
    got = motion_encoder(corr, flow, weights)
    torch.cuda.synchronize()
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-5, err


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", SHAPES + [(1, 60, 107)])
def test_gru_flowhead_kernel_matches_plain(cuda_device, b, h, w):
    """Also at the TC shape 1x60x107, which the model gates off this kernel
    (above 4096 positions) but the wrapper takes."""
    net, x, p = gru_flowhead_inputs(np.random.default_rng(6), b, h, w)
    net, x = to_nchw(net).to(cuda_device), to_nchw(x).to(cuda_device)
    weights = weights_to(port_gru_flowhead_weights(p), cuda_device)
    before = gru_flowhead.launches
    got_net, got_delta = gru_flowhead(net, x, weights)
    torch.cuda.synchronize()
    assert gru_flowhead.launches == before + 1
    want_net, want_delta = gru_flowhead_plain(net, x, weights)
    torch.testing.assert_close(got_net, want_net, rtol=0, atol=1e-4)
    torch.testing.assert_close(got_delta, want_delta, rtol=0, atol=1e-4)


def _local_agg_case(device, seed, b, h, w, cd=128, cv=256):
    return tuple(to_nchw(a).to(device) for a in local_agg_inputs(
        np.random.default_rng(seed), b, h, w, cd, cv))


def _near_ties(x, yd, r):
    """[B, H, W]: the two largest window distances are in the image and lie
    within 1e-4 relative, where rounding may flip the argmax."""
    dist = local_pairwise_dist(x, yd, r).flatten(1, 2)
    if r == 0:                                   # a window of one position
        return torch.zeros_like(dist[:, 0], dtype=torch.bool)
    top = torch.topk(dist, 2, dim=1).values
    return (top[:, 0] < 1e19) & (top[:, 0] - top[:, 1]
                                 <= 1e-4 * top[:, 0].abs())


def _check_local_agg(mode, x, yd, yv, r):
    fn = getattr(local_agg, f"local_{mode}_aggregate")
    before = fn.launches
    got = fn(x, yd, yv, r)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = getattr(local_agg, f"local_{mode}_aggregate_plain")(x, yd, yv, r)
    if mode != "nearest":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
        return
    keep = ~_near_ties(x, yd, r)[:, None].expand_as(got)
    torch.testing.assert_close(got[keep], want[keep], rtol=0, atol=0)


MODES = ["sigmoid", "softmax", "nearest"]


def _local_agg_float64(mode, x, yd, yv, r, temp=3.0):
    """The plain versions' composition in float64 (they compute in float32
    whatever their inputs): dist over the window with 1e20 outside the
    image, then the mode's weights and the window sum, or the value at the
    first argmax."""
    x, yd, yv = x.double(), yd.double(), yv.double()
    h, w = x.shape[-2:]
    k = 2 * r + 1
    y2 = F.pad(yd.square().sum(1), (r, r, r, r), value=1e20)
    yp, vp = F.pad(yd, (r, r, r, r)), F.pad(yv, (r, r, r, r))
    x2 = x.square().sum(1)
    offsets = [(dy, dx) for dy in range(k) for dx in range(k)]
    dist = torch.stack([
        x2 + y2[:, dy:dy + h, dx:dx + w]
        - 2.0 * (x * yp[:, :, dy:dy + h, dx:dx + w]).sum(1)
        for dy, dx in offsets], 1)                       # [B, k*k, H, W]
    if mode == "nearest":
        pick = dist.argmax(1)
        out = torch.zeros_like(yv)
        for n, (dy, dx) in enumerate(offsets):
            out += (pick == n)[:, None] * vp[:, :, dy:dy + h, dx:dx + w]
        return out
    if mode == "softmax":
        wts = torch.softmax(1.0 / (dist * temp + 1e-5), 1)
    else:
        wts = 1.0 - (torch.sigmoid(dist) - 0.5) * 2.0
    out = torch.zeros_like(yv)
    for n, (dy, dx) in enumerate(offsets):
        out += wts[:, n, None] * vp[:, :, dy:dy + h, dx:dx + w]
    return out / (k * k)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,r", [(1, 37, 53, 2), (2, 37, 53, 10),
                                     (1, 60, 107, 10), (2, 60, 107, 2),
                                     (1, 37, 53, 0), (1, 37, 53, 15),
                                     (1, 6, 41, 15)])
@pytest.mark.parametrize("mode", MODES)
def test_local_agg_kernel_matches_plain(cuda_device, mode, b, h, w, r):
    """H = 37 and 6 are not multiples of a block's 4 query rows, W = 53, 41
    and 107 end in a partial 32-column tile; r = 0 (one key) to 15 (the
    largest window, three 16-key groups; at H = 6 every window reaches
    rows outside the image above and below)."""
    _check_local_agg(mode, *_local_agg_case(cuda_device, 7 + r, b, h, w), r)


@pytest.mark.cuda
@pytest.mark.parametrize("cd,cv", [(128, 320), (64, 256), (200, 256),
                                   (256, 64)])
@pytest.mark.parametrize("mode", MODES)
def test_local_agg_kernel_channel_counts(cuda_device, mode, cd, cv):
    """Cv = 320: three value chunks of 128, the last partial; Cd = 64; Cd =
    200 and 256 (the wrapper's limit): two query rows a block and y_dist in
    two stages a key row, the second partial for 200."""
    _check_local_agg(mode, *_local_agg_case(cuda_device, 3, 1, 21, 45, cd,
                                            cv), 6)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_local_agg_kernel_matches_float64(cuda_device, mode):
    """At our_warp's eval shape (1x60x107, Cd 128, Cv 256, r 10) the 3xTF32
    products hold sigmoid and softmax within 1e-5 of the largest output of
    a float64 evaluation; nearest picks what float64 picks off near-ties."""
    x, yd, yv = _local_agg_case(cuda_device, 17, 1, 60, 107)
    r = 10
    want = _local_agg_float64(mode, x, yd, yv, r)
    got = getattr(local_agg, f"local_{mode}_aggregate")(x, yd, yv, r)
    torch.cuda.synchronize()
    if mode != "nearest":
        err = (got.double() - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err
        return
    keep = ~_near_ties(x, yd, r)[:, None].expand_as(got)
    torch.testing.assert_close(got[keep].double(), want[keep], rtol=0,
                               atol=0)


def _check_local_agg_valid(mode, x, yd, yv, r, hv, wv):
    """B5 with a valid size: within the bars of its plain version (the band
    zero on both), zero beyond the valid size, and on the valid region
    bitwise the launch on the contiguous crop."""
    fn = getattr(local_agg, f"local_{mode}_aggregate")
    before = fn.launches
    got = fn(x, yd, yv, r, valid_hw=(hv, wv))
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert not got[..., hv:, :].any() and not got[..., :hv, wv:].any()
    want = getattr(local_agg, f"local_{mode}_aggregate_plain")(
        x, yd, yv, r, valid_hw=(hv, wv))
    if mode != "nearest":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    else:
        dist = local_pairwise_dist(x, yd, r, (hv, wv)).flatten(1, 2)
        top = torch.topk(dist, 2, dim=1).values
        tie = (top[:, 0] < 1e19) & (top[:, 0] - top[:, 1]
                                    <= 1e-4 * top[:, 0].abs())
        keep = ~tie[:, None].expand_as(got)
        torch.testing.assert_close(got[keep], want[keep], rtol=0, atol=0)
    crop = [t[..., :hv, :wv].contiguous() for t in (x, yd, yv)]
    assert torch.equal(got[..., :hv, :wv], fn(*crop, r))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,hv,wv,r", [
    (37, 80, 30, 80, 4),      # rows only
    (37, 80, 37, 61, 4),      # columns only, 61 not a multiple of 32
    (37, 80, 30, 45, 10),     # both
    (37, 80, 5, 3, 10),       # a valid region smaller than a window
    (60, 112, 60, 107, 10),   # our_warp's bucket at 480x853
    (60, 160, 57, 100, 10)])  # column tiles wholly beyond the valid size
@pytest.mark.parametrize("mode", MODES)
def test_local_agg_kernel_valid_size(cuda_device, mode, h, w, hv, wv, r):
    x, yd, yv = _local_agg_case(cuda_device, 11 + hv, 2 if h == 37 else 1,
                                h, w)
    _check_local_agg_valid(mode, x, yd, yv, r, hv, wv)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_local_agg_kernel_whole_grid_is_unpadded(cuda_device, mode):
    """(Hv, Wv) = (H, W) is bitwise the call without a valid size."""
    x, yd, yv = _local_agg_case(cuda_device, 13, 1, 60, 107)
    fn = getattr(local_agg, f"local_{mode}_aggregate")
    assert torch.equal(fn(x, yd, yv, 10, valid_hw=(60, 107)),
                       fn(x, yd, yv, 10))


@pytest.mark.cuda
@pytest.mark.parametrize("valid", [(61, 107), (60, 113), (0, 107),
                                   (60, 0)])
def test_local_agg_kernel_refuses_a_valid_size_outside(cuda_device, valid):
    x, yd, yv = _local_agg_case(cuda_device, 14, 1, 60, 107)
    for mode in MODES:
        fn = getattr(local_agg, f"local_{mode}_aggregate")
        before = fn.launches
        with pytest.raises(ValueError, match="outside the"):
            fn(x, yd, yv, 10, valid_hw=valid)
        assert fn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("valid", [None, (60, 107)])
@pytest.mark.parametrize("mode", MODES)
def test_local_agg_kernel_merge_shape(cuda_device, mode, valid):
    """our_warp_merge's warp: 256-d C4 embeddings for the distances, 256-d
    values, exact (60x107) and bucketed (60x112, valid 60x107)."""
    w = 107 if valid is None else 112
    x, yd, yv = _local_agg_case(cuda_device, 15, 1, 60, w, cd=256, cv=256)
    if valid is None:
        _check_local_agg(mode, x, yd, yv, 10)
    else:
        _check_local_agg_valid(mode, x, yd, yv, 10, *valid)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,hv,wv", [
    ((1, 256, 60, 112), 60, 107),      # R101 bucket feature: columns only
    ((2, 64, 64, 112), 60, 107),       # batch 2, both bands
    ((2, 32, 64, 112), 57, 112),       # rows only
    ((1, 16, 31, 57), 29, 53),         # odd W: no 16-byte stores
    ((3, 2, 17, 45), 11, 40),          # odd W, both bands
    ((1200, 1, 30, 56), 30, 53),       # a correlation-pyramid level
    ((3, 5, 7), 0, 4),                 # every row is band
    ((2, 3, 20, 100), 20, 60),         # a column run of 40 floats
    ((2, 3, 21, 100), 17, 60),         # 40 floats and a row band
    ((70000, 1, 8, 16), 6, 13),        # more planes than gridDim.y allows
    ((1, 2048, 60, 112), 60, 107),     # the smoke's shapes: C5,
    ((6720, 1, 30, 56), 30, 53),       # the TC pair's pyramid level,
    ((1, 256, 64, 112), 57, 112),      # rows only
])
def test_band_zero_kernel_matches_plain(cuda_device, shape, hv, wv):
    x = torch.randn(*shape, device=cuda_device)
    want = band_zero_plain(x.clone(), hv, wv)
    before = band_zero.launches
    got = band_zero(x, hv, wv)
    torch.cuda.synchronize()
    assert got is x and band_zero.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_band_zero_kernel_no_band_no_launch(cuda_device):
    x = torch.randn(2, 8, 60, 112, device=cuda_device)
    want = x.clone()
    before = band_zero.launches
    assert band_zero(x, 60, 112) is x
    assert band_zero.launches == before and torch.equal(x, want)


@pytest.mark.cuda
def test_band_zero_kernel_refuses_strided_and_grad(cuda_device):
    x = torch.randn(1, 4, 60, 112, device=cuda_device)
    before = band_zero.launches
    with pytest.raises(ValueError, match="contiguous"):
        band_zero(x.permute(0, 2, 3, 1), 50, 3)
    with pytest.raises(ValueError, match="requires grad"):
        band_zero(x.requires_grad_(), 50, 100)
    assert band_zero.launches == before


@pytest.mark.cuda
def test_kernels_launch_on_the_current_stream(cuda_device):
    """The wrappers launch on PyTorch's current stream (a side stream here),
    read without building a torch.cuda.Stream."""
    levels, coords = _lookup_case(cuda_device, 5, 1, 16, 24)
    x = torch.randn(2, 8, 30, 56, device=cuda_device)
    want_x = band_zero_plain(x.clone(), 25, 50)
    want = lookup_corr_pyramid_plain(levels, coords)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = lookup_corr_pyramid(levels, coords)
        band_zero(x, 25, 50)
    side.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(x, want_x)


@pytest.mark.cuda
def test_graph_capture_counts_and_timing_restores(cuda_device):
    """Capturing a wrapper into a CUDA graph runs its Python once a call, so
    its counter counts the captured launches; a replay runs no Python and
    counts none, but does run the kernel.  kernels/timing.py puts the
    counters of the wrappers it is given back as they were."""
    from cvpr2021_vspw_implement_tpu_torch.kernels import timing
    x = torch.randn(1, 16, 30, 56, device=cuda_device)
    graph = torch.cuda.CUDAGraph()
    band_zero(x, 30, 50)                      # build and load outside
    torch.cuda.synchronize()
    before = band_zero.launches
    with torch.cuda.graph(graph):
        for _ in range(3):
            band_zero(x, 30, 50)
    assert band_zero.launches == before + 3
    x.normal_()
    want = band_zero_plain(x.clone(), 30, 50)
    graph.replay()
    torch.cuda.synchronize()
    assert band_zero.launches == before + 3 and torch.equal(x, want)

    levels, coords = _lookup_case(cuda_device, 6, 1, 16, 24)
    counts = band_zero.launches, lookup_corr_pyramid.launches
    for clock in (timing.device_ms, timing.enqueue_ms, timing.profiler_ms):
        clock(lambda: band_zero(x, 30, 50), counted=(band_zero,))
        clock(lambda: lookup_corr_pyramid(levels, coords),
              counted=(lookup_corr_pyramid,))
    assert (band_zero.launches, lookup_corr_pyramid.launches) == counts


# B5's backward (kernels/csrc/local_agg_bwd.cu): within 1e-4 of the largest
# gradient of a float64 run of the plain backward on near-match inputs, and
# of the f32 plain backward up to that one's own distance from float64 (both
# sum up to 441 window terms of 128-256 channel products in other orders;
# softmax's G carries s^2, up to 1e3 here, times the rounding of distances
# of 0.01-0.1 taken from norms near 0.3: the f32 plain's dx was 1.5e-4 of
# its largest element from the kernel, which the float64 run holds within
# 1e-4); nearest equal off near-ties, through the forward kernel's own index

def _backward_case(device, seed, b, h, w, cd=128, cv=256):
    x, yd, yv = _local_agg_case(device, seed, b, h, w, cd, cv)
    g = torch.from_numpy(np.random.default_rng(seed + 100).standard_normal(
        (b, cv, h, w)).astype(np.float32)).to(device)
    return x, yd, yv, g


def _check_backward(mode, x, yd, yv, g, r):
    kw = {"temp": 3.0} if mode == "softmax" else {}
    fn = getattr(local_agg, f"local_{mode}_aggregate_backward")
    plain = getattr(local_agg, f"local_{mode}_aggregate_backward_plain")
    before = fn.launches
    got = fn(x, yd, yv, g, r, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(x, yd, yv, g, r, **kw)
    exact = plain(*(t.double() for t in (x, yd, yv, g)), r, **kw)
    for name, a, b, e in zip(("x", "y_dist", "y_val"), got, want, exact):
        scale = e.abs().max().item()
        if mode == "softmax" and r == 0 and name != "y_val":
            # a one-position window weighs 1 whatever the distance
            assert scale == 0 and not a.any(), name
            continue
        assert scale > 0, name
        err = (a.double() - e).abs().max().item()
        assert err <= 1e-4 * scale, (name, err, scale)
        own = (b.double() - e).abs().max().item()
        assert (a - b).abs().max().item() <= 1e-4 * scale + own, name


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,r,cd", [
    (2, 60, 60, 10, 128),     # our_warp's training shape
    (2, 60, 60, 10, 256),     # our_warp_merge's
    (1, 37, 53, 0, 128),      # one key
    (1, 37, 53, 15, 128),     # the largest window
    (2, 6, 41, 15, 64),       # 6 rows: every window leaves the image
    (1, 21, 45, 6, 200)])     # a partial channel chunk
@pytest.mark.parametrize("mode", ["sigmoid", "softmax"])
def test_local_agg_backward_kernel_matches_plain(cuda_device, mode, b, h, w,
                                                 r, cd):
    _check_backward(mode, *_backward_case(cuda_device, 30 + r, b, h, w, cd),
                    r)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sigmoid", "softmax"])
def test_local_agg_backward_kernel_matches_float64(cuda_device, mode):
    """At our_warp_merge's shape, another seed."""
    _check_backward(mode, *_backward_case(cuda_device, 41, 2, 60, 60, 256),
                    10)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,r,cd,cv", [
    (1, 33, 65, 10, 128, 256),    # 65 columns: a third block of one column
    (1, 17, 129, 10, 256, 256),   # 129 columns, 17 rows, our_warp_merge's Cd
    (1, 17, 129, 13, 256, 256),   # six key tiles: y_val in two stages
    (1, 21, 45, 6, 128, 320),     # three dy_val chunks of 128, the last 64
    (1, 21, 45, 10, 100, 40)])    # partial 32-channel K steps of both
@pytest.mark.parametrize("mode", ["sigmoid", "softmax"])
def test_local_agg_backward_kernel_tiles(cuda_device, mode, b, h, w, r, cd,
                                         cv):
    """The tensor-core kernels' tiles at ragged edges: widths and heights
    that are not multiples of the 32-column blocks or the 16-position
    m-tiles, Cv past one key-side chunk, channels past a K step."""
    _check_backward(mode, *_backward_case(cuda_device, 70 + r, b, h, w, cd,
                                          cv), r)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sigmoid", "softmax"])
def test_local_agg_backward_kernel_is_deterministic(cuda_device, mode):
    """No atomics: two launches on the same inputs agree bit for bit."""
    x, yd, yv, g = _backward_case(cuda_device, 80, 2, 60, 60)
    fn = getattr(local_agg, f"local_{mode}_aggregate_backward")
    first = fn(x, yd, yv, g, 10)
    second = fn(x, yd, yv, g, 10)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_local_agg_backward_kernel_refuses_wide_cd(cuda_device):
    """Cd > 256, as the forward kernel: refused before any launch."""
    x, yd, yv, g = _backward_case(cuda_device, 81, 1, 8, 12, 264, 16)
    fn = local_agg.local_sigmoid_aggregate_backward
    before = fn.launches
    with pytest.raises(ValueError, match="Cd <= 256"):
        fn(x, yd, yv, g, 2)
    assert fn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,r,cd", [
    (2, 60, 60, 10, 128), (2, 60, 60, 10, 256), (1, 37, 53, 0, 128),
    (1, 37, 53, 15, 128), (2, 6, 41, 15, 64)])
def test_nearest_backward_kernel_matches_plain(cuda_device, b, h, w, r, cd):
    """The forward's index is the plain argmax off near-ties, the output is
    bitwise the forward without an index, and the backward through the
    shared index equals the plain one bitwise (the same additions in the
    same order)."""
    x, yd, yv, g = _backward_case(cuda_device, 50 + r, b, h, w, cd)
    out, idx = local_agg.local_nearest_aggregate_index(x, yd, yv, r)
    torch.cuda.synchronize()
    assert torch.equal(out, local_agg.local_nearest_aggregate(x, yd, yv, r))
    keep = ~_near_ties(x, yd, r)
    want_idx = local_agg.local_nearest_index_plain(x, yd, r)
    assert torch.equal(idx.long()[keep], want_idx[keep])
    fn = local_agg.local_nearest_aggregate_backward
    before = fn.launches
    got = fn(idx, g, r)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = local_agg.local_nearest_aggregate_backward_plain(idx.long(), g, r)
    assert torch.equal(got, want)
    if r < 15:
        assert got.abs().max() > 0


def _nearest_index(kind, x, yd, yv, r, rng):
    """The index the nearest backward gathers through: ``crowded`` the
    forward kernel's on the smoke's crowded y_dist (each key at rows and
    columns r mod 2r + 1 inside the border picked by every query of its
    window); ``outside`` built so that every query picks a window row above
    the image (needs H <= r); ``same`` every query the same offset (at most
    one pick a key); ``random`` uniform offsets."""
    b, _, h, w = x.shape
    k = 2 * r + 1
    if kind == "crowded":
        _, idx = local_agg.local_nearest_aggregate_index(
            x, chip_smoke.crowded_y_dist(torch, yd, r), yv, r)
        return idx
    if kind == "outside":
        assert h <= r
        offsets = rng.integers(0, k, (b, h, w))            # dy = 0
    elif kind == "same":
        offsets = np.full((b, h, w), (k * k) // 2 + 1)
    else:
        offsets = rng.integers(0, k * k, (b, h, w))
    return torch.from_numpy(offsets.astype(np.int32)).to(x.device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,h,w,r,cv", [
    ("crowded", 2, 60, 60, 10, 256),   # 441 picks on a key, as in the smoke
    ("crowded", 1, 77, 77, 15, 200),   # 961 on one, ragged Cv and W
    ("outside", 2, 6, 41, 10, 256),    # every pick outside: all zeros
    ("same", 1, 37, 53, 10, 256),      # at most one pick a key
    ("random", 2, 60, 60, 10, 256),
    ("random", 1, 30, 53, 10, 200),    # Cv not a multiple of 32
    ("random", 1, 30, 41, 10, 512),    # two 256-channel tiles
    ("random", 1, 37, 53, 0, 256),     # a window of one position
    ("random", 1, 37, 41, 15, 256)])   # the largest window
def test_nearest_backward_kernel_at_any_index(cuda_device, kind, b, h, w, r,
                                              cv):
    """The nearest backward kernel bitwise the plain backward through the
    same index, however the picks crowd or scatter."""
    rng = np.random.default_rng(90 + r)
    x, yd, yv, g = _backward_case(cuda_device, 90 + r, b, h, w, 128, cv)
    idx = _nearest_index(kind, x, yd, yv, r, rng)
    picks = chip_smoke.nearest_picks(torch, idx, r)
    if kind == "crowded":
        assert picks.max() == (2 * r + 1) ** 2
    elif kind == "outside":
        assert not picks.any()
    elif kind == "same":
        assert picks.max() == 1
    fn = local_agg.local_nearest_aggregate_backward
    before = fn.launches
    got = fn(idx, g, r)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = local_agg.local_nearest_aggregate_backward_plain(idx.long(), g, r)
    assert torch.equal(got, want)
    assert got.abs().max() > 0 if picks.any() else not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sigmoid", "softmax", "nearest"])
def test_local_agg_autograd_on_the_card(cuda_device, mode):
    """``.backward()`` through the public function launches the forward and
    the backward kernels once each and gives the plain backward's
    gradients (nearest: through the forward kernel's index)."""
    x, yd, yv, g = _backward_case(cuda_device, 60, 2, 30, 40)
    ts = [t.clone().requires_grad_() for t in (x, yd, yv)]
    fwd = getattr(local_agg, f"local_{mode}_aggregate")
    bwd = getattr(local_agg, f"local_{mode}_aggregate_backward")
    counts = fwd.launches, bwd.launches
    out = fwd(*ts, 5)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (counts[0] + 1, counts[1] + 1)
    if mode == "nearest":
        _, idx = local_agg.local_nearest_aggregate_index(x, yd, yv, 5)
        assert ts[0].grad is None and ts[1].grad is None
        assert torch.equal(ts[2].grad, local_agg.
                           local_nearest_aggregate_backward_plain(
                               idx.long(), g, 5))
        return
    want = getattr(local_agg, f"local_{mode}_aggregate_backward_plain")(
        x, yd, yv, g, 5)
    for t, b in zip(ts, want):
        assert (t.grad - b).abs().max() <= 1e-4 * b.abs().max()
    with pytest.raises(ValueError, match="eval only"):
        fwd(*ts, 5, valid_hw=(20, 30))


class _RandomClips:
    """Clip items [4 x (479, 479, 3) float32], [4 x (479, 479) int32],
    fixed by the index."""

    def __len__(self):
        return 128

    def __getitem__(self, idx):
        rng = np.random.default_rng(idx)
        imgs = [rng.standard_normal((479, 479, 3), np.float32)
                for _ in range(4)]
        labs = [rng.integers(0, 124, (479, 479)).astype(np.int32)
                for _ in range(4)]
        return imgs, labs


@pytest.mark.cuda
def test_device_prefetch_matches_blocking_copies(cuda_device):
    """64 batches of the clip shape (4 x 2 x 479, pinned by the loader's
    worker, copied on the side stream two ahead) equal, tensor by tensor,
    blocking copies of the same host batches, with a train step on the
    compute stream between them that reads each batch."""
    from cvpr2021_vspw_implement_tpu_torch.data import (
        PrefetchLoader, make_collate_target_last)
    from cvpr2021_vspw_implement_tpu_torch.parallel import (
        device_prefetch, pinned_collate, to_device)

    dataset, collate = _RandomClips(), make_collate_target_last(0)
    loader = PrefetchLoader(dataset, 2, pinned_collate(collate, "cuda"),
                            seed=3, prefetch=2)
    order = list(PrefetchLoader(dataset, 2, collate, seed=3)
                 ._index_batches())
    conv = torch.nn.Conv2d(3, 64, 3, padding=1).cuda()
    opt = torch.optim.SGD(conv.parameters(), lr=1e-3)
    n = 0
    for idxs, batch in zip(order, device_prefetch(loader, "cuda", 2)):
        loss = conv(batch["img"].flatten(0, 1)).square().mean() \
            + 1e-6 * batch["labels"].float().mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        want = to_device(collate([dataset[int(i)] for i in idxs]), "cuda")
        assert sorted(batch) == sorted(want)
        for key in want:
            assert batch[key].dtype == want[key].dtype, key
            assert torch.equal(batch[key], want[key]), (n, key)
        n += 1
    assert n == 64


@pytest.mark.cuda
def test_frame_eval_launches_band_zero_as_the_model_implies(cuda_device,
                                                            tmp_path):
    """The per-frame eval of a seeded R18 ``ppm_deepsup`` model in the 64x64
    bucket (48x56 frames: every level has a band) launches B6 the trunk's
    spatial convs + 6 times a frame and nothing else; its PNGs differ from
    the exact eval's at no more than 0.1% of the pixels (cuDNN picks its
    algorithms per width, so a near-tie pixel may flip; the smoke holds
    the R101 model's logits)."""
    from cvpr2021_vspw_implement_tpu_torch import bench, test
    from cvpr2021_vspw_implement_tpu_torch.data import make_synthetic_vspw
    from PIL import Image

    root = str(tmp_path / "vspw")
    make_synthetic_vspw(root, 2, 3, (48, 56), 5, seed=4)
    preset = os.path.join(os.path.dirname(test.__file__), "config",
                          "presets", "vsp-resnet18dilated-ppm_deepsup.yaml")
    preds = {}
    for bucket in (0, 64):
        for fn in bench.WRAPPERS.values():
            fn.launches = 0
        out = str(tmp_path / f"preds_{bucket}")
        metrics, _ = test.main(["--cfg", preset, "--dataroot", root,
                                "--num_class", "5", "--width_bucket",
                                str(bucket), "--is_save", "--saveroot", out])
        got = {n: fn.launches for n, fn in bench.WRAPPERS.items()}
        per_frame = chip_smoke.frame_band_launches(torch, "resnet18dilated")
        want = {"band_zero": 6 * per_frame} if bucket else {}
        assert got == {n: want.get(n, 0) for n in got}
        assert np.isfinite(metrics["mIoU"])
        preds[bucket] = [np.asarray(Image.open(os.path.join(d, f)))
                         for d in sorted(os.path.join(out, v) for v in
                                         os.listdir(out) if v != "vmiou.pkl")
                         for f in sorted(os.listdir(d))]
    assert len(preds[0]) == 6
    differ = sum(int((a != b).sum()) for a, b in zip(preds[0], preds[64]))
    assert differ <= 1e-3 * 6 * 48 * 56


def _r18(method, device, raft_iters=3):
    """A seeded R18 model of ``method`` (fc_dim 512, 5 classes) in eval
    mode on ``device``."""
    import argparse

    from cvpr2021_vspw_implement_tpu_torch.config import cfg as default_cfg
    from cvpr2021_vspw_implement_tpu_torch.methods import build_method
    from cvpr2021_vspw_implement_tpu_torch.models.layers import init_weights

    cfg = default_cfg.clone()
    cfg.MODEL.arch_encoder = "resnet18dilated"
    cfg.MODEL.fc_dim = 512
    cfg.TPU.raft_iters = raft_iters
    model, _ = build_method(method, cfg, argparse.Namespace(
        num_class=5, clip_num=2 if method.startswith("netwarp") else 4,
        dilation_num=0))
    init_weights(model, torch.Generator().manual_seed(0))
    return model.to(device).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["netwarp", "netwarp_ocr"])
def test_netwarp_pair_launches_as_raft_implies(cuda_device, method):
    """A NetWarp pair of 480x560 frames (RAFT's 60x70 features pass B4's
    4096 gate) through the streaming engines: B1 once and B4 twice a
    refinement, exact and in the 480x576 bucket, where B6 launches the
    derived count of chip_smoke.py's ``ocr_netwarp_band_launches``; the
    bucketed prediction differs from the exact one at no more than 0.1% of
    the pixels.  The blend weights are live
    (``chip_smoke.live_netwarp_blend``), so the predictions read the
    bucketed feature warps."""
    from cvpr2021_vspw_implement_tpu_torch import bench, serving

    model = chip_smoke.live_netwarp_blend(torch, _r18(method, cuda_device))
    rng = np.random.default_rng(6)
    frames = [rng.normal(size=(480, 560, 3)).astype(np.float32)
              for _ in range(2)]
    preds = {}
    for engine in (serving.NetWarpEngine(model),
                   serving.NetWarpBucketEngine(model, bucket=64)):
        with torch.inference_mode():
            prev = engine.encode(frames[0])
            for fn in bench.WRAPPERS.values():
                fn.launches = 0
            target = engine.encode(frames[1])
            preds[type(engine)] = engine.fuse(target, prev, (480, 560))
        torch.cuda.synchronize()
        got = {n: fn.launches for n, fn in bench.WRAPPERS.items()}
        want = {"corr_lookup": 3, "sep_gru": 6}
        if isinstance(engine, serving.NetWarpBucketEngine):
            want["band_zero"] = chip_smoke.ocr_netwarp_band_launches(
                torch, model.raft, "resnet18dilated")[method]
        assert got == {n: want.get(n, 0) for n in got}
    a, b = preds.values()
    assert a.shape == b.shape == (480, 560)
    assert (a != b).sum() <= 1e-3 * a.size


@pytest.mark.cuda
def test_clip_ocr_bucketed_gather_matches_exact(cuda_device):
    """ClipOCR's bucketed ``encode_frame`` (48x72 in the 64x128 bucket) on
    the card: the features zero on the band and their valid region, and
    the region context gathered over it, within 1e-4 of the largest value
    of the exact run's (cuDNN sums in another order per width)."""
    model = _r18("clip_ocr", cuda_device)
    x = torch.randn(1, 3, 48, 72, generator=torch.Generator().manual_seed(7))
    x = x.to(cuda_device)
    padded = torch.zeros(1, 3, 64, 128, device=cuda_device)
    padded[..., :48, :72] = x
    with torch.inference_mode():
        feat, ctx = model.encode_frame(x)
        feat_b, ctx_b = model.encode_frame(padded, valid_hw=(48, 72))
    assert feat.shape[-2:] == (6, 9) and ctx_b.shape == ctx.shape
    assert not feat_b[..., 6:, :].any() and not feat_b[..., :, 9:].any()
    for got, want in ((feat_b[..., :6, :9], feat), (ctx_b, ctx)):
        assert (got - want).abs().max().item() <= 1e-4 * max(
            1.0, want.abs().max().item())



@pytest.mark.cuda
def test_tdnet_bucketed_stream_launches_and_matches_exact(cuda_device):
    """TDNet (four seeded R18 paths, crop 63, live weights as the smoke's:
    ``chip_smoke.live_td4_weights``) streams 6 frames of 48x72 exact and
    in the 64x128 bucket on the card: B6 launches
    ``chip_smoke.tdnet_band_launches`` a bucketed frame and nothing else
    launches; the bucketed logits on the valid region within 1e-4 of the
    largest exact logit, frame by frame (the attention runs from the
    fourth)."""
    from cvpr2021_vspw_implement_tpu_torch import bench
    from cvpr2021_vspw_implement_tpu_torch.models import td4_psp
    from cvpr2021_vspw_implement_tpu_torch.models.layers import init_weights
    from cvpr2021_vspw_implement_tpu_torch.ops.masked import pad_to

    model = td4_psp.TD4PSP(5, cropsize=63)
    init_weights(model, torch.Generator().manual_seed(0))
    model = chip_smoke.live_td4_weights(torch, model).to(cuda_device).eval()
    frames = torch.randn(6, 1, 3, 48, 72,
                         generator=torch.Generator().manual_seed(8))
    frames = frames.to(cuda_device)
    outs = {}
    for bucketed in (False, True):
        state = td4_psp.init_td4_state(1, td4_psp.td4_tokens(
            *((64, 128) if bucketed else (48, 72))), cuda_device)
        for fn in bench.WRAPPERS.values():
            fn.launches = 0
        logits = []
        with torch.inference_mode():
            for i, f in enumerate(frames):
                kw = {"valid_hw": (48, 72)} if bucketed else {}
                out, state = model.stream(pad_to(f, (64, 128)) if bucketed
                                          else f, i % 4, state, **kw)
                logits.append(out[..., :6, :9].clone())
        torch.cuda.synchronize()
        got = {n: fn.launches for n, fn in bench.WRAPPERS.items()}
        want = 6 * chip_smoke.tdnet_band_launches(torch) if bucketed else 0
        assert got == {n: want if n == "band_zero" else 0 for n in got}
        outs[bucketed] = logits
    scale = max(e.abs().max().item() for e in outs[False])
    for e, b in zip(outs[False], outs[True]):
        assert (b - e).abs().max().item() <= 1e-4 * scale


@pytest.mark.cuda
def test_nonlocal3d_bucketed_window_launches_and_matches_exact(cuda_device):
    """A Non-local 3D window (seeded R18, the block's residual scale live:
    ``chip_smoke.live_nonlocal_scale``) of 3 frames of 48x72, exact and in
    the 64x128 bucket on the card: B6 launches
    ``chip_smoke.nonlocal3d_band_launches`` and nothing else launches; the
    bucketed logits on the valid region within 1e-4 of the largest exact
    logit."""
    from cvpr2021_vspw_implement_tpu_torch import bench
    from cvpr2021_vspw_implement_tpu_torch.ops.masked import pad_to

    model = chip_smoke.live_nonlocal_scale(torch, _r18("nonlocal3d",
                                                      cuda_device))
    x = torch.randn(3, 1, 3, 48, 72,
                    generator=torch.Generator().manual_seed(9)).to(
                        cuda_device)
    with torch.inference_mode():
        exact = model(x)
        for fn in bench.WRAPPERS.values():
            fn.launches = 0
        bucketed = model(pad_to(x, (64, 128)), valid_hw=(48, 72))
    torch.cuda.synchronize()
    got = {n: fn.launches for n, fn in bench.WRAPPERS.items()}
    want = chip_smoke.nonlocal3d_band_launches(torch, "resnet18dilated")
    assert got == {n: want if n == "band_zero" else 0 for n in got}
    assert (bucketed[..., :6, :9] - exact).abs().max().item() <= 1e-4 * (
        exact.abs().max().item())

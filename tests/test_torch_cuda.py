"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and imports no JAX, so it runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a card every test skips.  Tolerances: the corr lookup is the same
f32 arithmetic (atol 1e-5); the GRU pass, the motion encoder and the GRU +
flow head sum products of up to 2304 terms in another order than cuDNN, the
last two through chains of five and six convolutions (atol 1e-4).  The
local aggregations (B5) sum 128-term distances and up to 441 weighted
values in another order than the plain version (sigmoid and softmax: atol
1e-5 and rtol 1e-4 per element, and at most 1e-4 of the largest output
overall, on the near-match inputs of ``local_agg_inputs``, whose window
weights are far from uniform and whose softmax scores stay far from the
pole of 1 / (dist * temp + 1e-5)); nearest must pick the same value except
where the two largest in-image window distances lie within 1e-4
relative.  The band re-zero (B6) only stores zeros: bitwise equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
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


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
def test_sep_gru_kernel_matches_plain(cuda_device, axis):
    rng = np.random.default_rng(3 + axis)
    args = [t.to(cuda_device)
            for t in port_gru_args(*gru_inputs(rng, 2, 11, 70, 128, 256, axis))]
    before = sep_conv_gru_pass.launches
    got = sep_conv_gru_pass(*args, axis)
    torch.cuda.synchronize()
    assert sep_conv_gru_pass.launches == before + 1
    torch.testing.assert_close(got, sep_conv_gru_pass_plain(*args, axis),
                               rtol=0, atol=1e-4)


SHAPES = [(1, 37, 53), (2, 37, 53), (1, 60, 60), (2, 60, 60)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", SHAPES)
def test_motion_encoder_kernel_matches_plain(cuda_device, b, h, w):
    corr, flow, p = motion_inputs(np.random.default_rng(5), b, h, w)
    corr, flow = to_nchw(corr).to(cuda_device), to_nchw(flow).to(cuda_device)
    weights = weights_to(port_motion_weights(p), cuda_device)
    before = motion_encoder.launches
    got = motion_encoder(corr, flow, weights)
    torch.cuda.synchronize()
    assert motion_encoder.launches == before + 1
    torch.testing.assert_close(got, motion_encoder_plain(corr, flow, weights),
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", SHAPES)
def test_gru_flowhead_kernel_matches_plain(cuda_device, b, h, w):
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,r", [(1, 37, 53, 2), (2, 37, 53, 10),
                                     (1, 60, 107, 10), (2, 60, 107, 2)])
@pytest.mark.parametrize("mode", ["sigmoid", "softmax", "nearest"])
def test_local_agg_kernel_matches_plain(cuda_device, mode, b, h, w, r):
    x, yd, yv = (to_nchw(a).to(cuda_device) for a in local_agg_inputs(
        np.random.default_rng(7 + r), b, h, w, 128, 256))
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
    top = torch.topk(local_pairwise_dist(x, yd, r).flatten(1, 2), 2,
                     dim=1).values
    tie = (top[:, 0] < 1e19) & (top[:, 0] - top[:, 1] <= 1e-4 * top[:, 0].abs())
    keep = ~tie[:, None].expand_as(got)
    torch.testing.assert_close(got[keep], want[keep], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,hv,wv", [
    ((1, 256, 60, 112), 60, 107),      # R101 bucket feature: columns only
    ((2, 64, 64, 112), 60, 107),       # batch 2, both bands
    ((2, 32, 64, 112), 57, 112),       # rows only
    ((1, 16, 31, 57), 29, 53),         # odd W: no 16-byte stores
    ((1200, 1, 30, 56), 30, 53),       # a correlation-pyramid level
    ((3, 5, 7), 0, 4),                 # every row is band
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

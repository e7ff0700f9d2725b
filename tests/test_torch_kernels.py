"""The port's two kernels: plain versions against the JAX functions they
replace, on the CPU (the CUDA kernels against their plain versions are in
tests/test_torch_cuda.py).

K1 (corr lookup) ↔ models/raft/corr.py::lookup_corr_pyramid and the Pallas
ops/pallas/corr.py::lookup_corr_pyramid_fused (interpret mode); K2 (one
separable GRU pass) ↔ ops/pallas/gru.py::sep_conv_gru_pass_xla and the
Pallas sep_conv_gru_pass (interpret mode).  Tolerance atol 1e-5: the same
f32 arithmetic, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2021_vspw_implement_tpu.models.raft.corr import \
    lookup_corr_pyramid as jax_lookup
from cvpr2021_vspw_implement_tpu.ops.pallas.corr import \
    lookup_corr_pyramid_fused
from cvpr2021_vspw_implement_tpu.ops.pallas.gru import (
    sep_conv_gru_pass as jax_gru_pallas, sep_conv_gru_pass_xla)
from cvpr2021_vspw_implement_tpu_torch.ops.corr_lookup import (
    lookup_corr_pyramid, lookup_corr_pyramid_plain)
from cvpr2021_vspw_implement_tpu_torch.ops.sep_gru import (
    sep_conv_gru_pass, sep_conv_gru_pass_plain)
from torch_port_util import gru_inputs, port_gru_args, pyramid, query_coords


@pytest.mark.parametrize("b,h,w", [(1, 9, 11), (2, 8, 13)])
def test_corr_lookup_plain_matches_jax(b, h, w):
    rng = np.random.default_rng(h * w)
    levels = pyramid(rng, b, h, w)       # P = 99 and 104: not /128
    coords = query_coords(rng, b, h, w)
    got = lookup_corr_pyramid_plain(
        [torch.from_numpy(l) for l in levels],
        torch.from_numpy(np.moveaxis(coords, -1, 1).copy()))
    got = np.moveaxis(got.numpy(), 1, -1)                 # [B, H, W, 324]
    pyr = [jnp.asarray(l) for l in levels]
    want = np.asarray(jax_lookup(pyr, jnp.asarray(coords), 4))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    fused = np.asarray(lookup_corr_pyramid_fused(pyr, jnp.asarray(coords), 4,
                                                 True))
    np.testing.assert_allclose(got, fused, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["huge", "window_outside", "across_64px",
                                  "level_7x13"])
def test_corr_lookup_far_coords_matches_jax(case):
    """The lookup on CPU tensors against the JAX functions where the card
    kernel takes care: coords of +-1e9 (an int cast of x0 + 1 would
    overflow); queries whose whole window lies outside level 0; coords from
    56 to 72 px, where c + d crosses 64 and rounds; a level 1 of 7x13 and a
    level 3 of 1x3, as levels 3 of RAFT at 60x107 and beyond, smaller than
    the 10x10 patch.  Across 64 px only against models/raft/corr.py: the
    Pallas kernel takes one fraction for all 9 taps of a query, where c + d
    rounds differently, and lands more than 1e-5 away there."""
    rng = np.random.default_rng(5)
    b, h, w = {"across_64px": (1, 16, 80), "level_7x13": (2, 14, 26)}.get(
        case, (2, 8, 13))
    levels = pyramid(rng, b, h, w)
    coords = query_coords(rng, b, h, w)                  # [B, H, W, 2]
    if case == "huge":
        coords[0, ::2, :, 0] = 1e9
        coords[1, 1::2, :, 1] = -1e9
    elif case == "window_outside":
        coords[:, :4, :, 0] = -5.5                # x0 = -6 on level 0
        coords[:, 4:, :, 1] = h + 4.25            # y0 = h + 4 on level 0
    elif case == "across_64px":
        coords[..., 0] = rng.uniform(56.0, 72.0, size=(b, h, w))
    got = lookup_corr_pyramid(
        [torch.from_numpy(l) for l in levels],
        torch.from_numpy(np.moveaxis(coords, -1, 1).copy()))
    got = np.moveaxis(got.numpy(), 1, -1)                 # [B, H, W, 324]
    if case == "window_outside":
        assert not got[:, :, :, :81].any()
    pyr = [jnp.asarray(l) for l in levels]
    np.testing.assert_allclose(
        got, np.asarray(jax_lookup(pyr, jnp.asarray(coords), 4)),
        atol=1e-5, rtol=0)
    if case != "across_64px":
        np.testing.assert_allclose(
            got, np.asarray(lookup_corr_pyramid_fused(
                pyr, jnp.asarray(coords), 4, True)), atol=1e-5, rtol=0)


def test_corr_lookup_cpu_tensor_takes_plain_version():
    rng = np.random.default_rng(0)
    levels = [torch.from_numpy(l) for l in pyramid(rng, 1, 6, 8)]
    coords = torch.from_numpy(np.moveaxis(query_coords(rng, 1, 6, 8), -1, 1)
                              .copy())
    before = lookup_corr_pyramid.launches
    torch.testing.assert_close(lookup_corr_pyramid(levels, coords),
                               lookup_corr_pyramid_plain(levels, coords),
                               rtol=0, atol=0)
    assert lookup_corr_pyramid.launches == before


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shape", [(1, 6, 13), (2, 9, 7)])
def test_sep_gru_plain_matches_jax(axis, shape):
    b, h, w = shape
    rng = np.random.default_rng(axis * 100 + h)
    ins = gru_inputs(rng, b, h, w, 32, 48, axis)
    got = np.moveaxis(sep_conv_gru_pass_plain(*port_gru_args(*ins), axis)
                      .numpy(), 1, -1)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(sep_conv_gru_pass_xla(
            *[jnp.asarray(a) for a in ins], axis=axis))
        pallas = np.asarray(jax_gru_pallas(
            *[jnp.asarray(a) for a in ins], axis=axis, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)


def test_sep_gru_cpu_tensor_takes_plain_version():
    rng = np.random.default_rng(1)
    args = port_gru_args(*gru_inputs(rng, 1, 4, 6, 64, 64, 0))
    before = sep_conv_gru_pass.launches
    torch.testing.assert_close(sep_conv_gru_pass(*args, 0),
                               sep_conv_gru_pass_plain(*args, 0),
                               rtol=0, atol=0)
    assert sep_conv_gru_pass.launches == before

"""The kernel wrappers' checks on the launch path, on the CPU.

Every wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA one; what it refuses, it refuses before anything is
launched and before its launch counter moves.  The corr lookup (B1) and the
band re-zero (B6) check their arguments on every device, so a strided
tensor, a tensor that requires grad or one on another device raises here
as on the card; the other wrappers check on the card only
(tests/test_torch_cuda.py), and on a device that is neither CPU nor CUDA
raise.  ``meta`` tensors stand for the other device.
"""

import numpy as np
import pytest
import torch

from cvpr2021_vspw_implement_tpu_torch.ops import local_agg
from cvpr2021_vspw_implement_tpu_torch.ops.band_zero import band_zero
from cvpr2021_vspw_implement_tpu_torch.ops.corr_lookup import \
    lookup_corr_pyramid
from cvpr2021_vspw_implement_tpu_torch.ops.gru_flowhead import gru_flowhead
from cvpr2021_vspw_implement_tpu_torch.ops.motion_encoder import \
    motion_encoder
from cvpr2021_vspw_implement_tpu_torch.ops.sep_gru import sep_conv_gru_pass
from torch_port_util import gru_inputs, port_gru_args, pyramid, query_coords


def _port(levels, coords_nhwc):
    return ([torch.from_numpy(l) for l in levels],
            torch.from_numpy(np.moveaxis(coords_nhwc, -1, 1).copy()))


def _b1_args(bad):
    rng = np.random.default_rng(0)
    levels, coords = _port(pyramid(rng, 1, 6, 8), query_coords(rng, 1, 6, 8))
    if bad == "strided coords":
        coords = coords.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "strided level":
        levels[1] = levels[1].transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "level on another device":
        levels[2] = levels[2].to("meta")
    elif bad == "wrong device":
        levels, coords = [l.to("meta") for l in levels], coords.to("meta")
    return levels, coords


@pytest.mark.parametrize("bad,error", [
    ("strided coords", ValueError), ("strided level", ValueError),
    ("level on another device", ValueError), ("wrong device", RuntimeError)])
def test_corr_lookup_refuses_before_launch(bad, error):
    """The wrapper checks every argument before it picks a device's path:
    the same refusals on the CPU as on the card, and no launch counted."""
    levels, coords = _b1_args(bad)
    before = lookup_corr_pyramid.launches
    with pytest.raises(error):
        lookup_corr_pyramid(levels, coords)
    assert lookup_corr_pyramid.launches == before


@pytest.mark.parametrize("bad,error", [
    ("strided", ValueError), ("requires grad", ValueError),
    ("wrong device", RuntimeError)])
def test_band_zero_refuses_before_launch(bad, error):
    """B6 checks strides, grad and the device before anything is
    launched."""
    x = torch.zeros(2, 3, 8, 10)
    if bad == "strided":
        x = x.transpose(2, 3)
    elif bad == "requires grad":
        x.requires_grad_()
    elif bad == "wrong device":
        x = x.to("meta")
    before = band_zero.launches
    with pytest.raises(error):
        band_zero(x, 5, 6)
    assert band_zero.launches == before


def _meta(*shape):
    return torch.empty(*shape, device="meta")


# (wrapper, its arguments on the meta device); the shapes are what each
# kernel takes, so only the device is wrong
OTHER_WRAPPERS = {
    "sep_gru": (sep_conv_gru_pass, lambda: (
        _meta(1, 32, 6, 8), _meta(1, 16, 6, 8), _meta(5, 64, 48),
        _meta(64), _meta(5, 32, 48), _meta(32), 0)),
    "motion_encoder": (motion_encoder, lambda: (
        _meta(1, 324, 6, 8), _meta(1, 2, 6, 8), {})),
    "gru_flowhead": (gru_flowhead, lambda: (
        _meta(1, 128, 6, 8), _meta(1, 256, 6, 8), {})),
    **{name: (getattr(local_agg, f"local_{name}_aggregate"), lambda: (
        _meta(1, 16, 6, 8), _meta(1, 16, 6, 8), _meta(1, 8, 6, 8), 2))
       for name in ("sigmoid", "softmax", "nearest")},
}


@pytest.mark.parametrize("name", list(OTHER_WRAPPERS))
def test_wrapper_refuses_other_device_before_launch(name):
    """B2-B5 on a device that is neither the CPU nor CUDA: an error, no
    plain version and no launch counted."""
    fn, args = OTHER_WRAPPERS[name]
    before = fn.launches
    with pytest.raises(RuntimeError, match="for device meta"):
        fn(*args())
    assert fn.launches == before


@pytest.mark.parametrize("name", ["sep_gru", "motion_encoder",
                                  "gru_flowhead"])
def test_update_wrappers_refuse_grad_before_launch(name):
    """B2-B4 have no backward: off the CPU, while grad is enabled, an
    operand that requires grad is refused before the device's path and no
    launch is counted; under ``no_grad`` the same operands go on to the
    launch path (here: the meta device's refusal)."""
    fn, make = OTHER_WRAPPERS[name]
    args = make()
    args = (args[0].requires_grad_(), *args[1:])
    before = fn.launches
    with pytest.raises(ValueError, match="requires grad"):
        fn(*args)
    with torch.no_grad(), pytest.raises(RuntimeError,
                                        match="for device meta"):
        fn(*args)
    assert fn.launches == before


def test_update_wrappers_stay_differentiable_on_the_cpu():
    """The plain versions that the CPU takes keep their autograd graph."""
    args = port_gru_args(*gru_inputs(np.random.default_rng(1), 1, 6, 8, 32,
                                     16, 0))
    args[0].requires_grad_()
    sep_conv_gru_pass(*args, 0).sum().backward()
    assert args[0].grad is not None and args[0].grad.abs().sum() > 0

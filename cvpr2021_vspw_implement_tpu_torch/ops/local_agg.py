"""Local cost-volume window aggregation: the CUDA kernels and their plain
versions (JAX counterparts: ops/pallas/local_agg.py::local_sigmoid_aggregate,
local_softmax_aggregate, local_nearest_aggregate, and the XLA composition
of models/warp_our.py::warp_one_scale over ops/local_pairwise.py).

Each function maps (x [B, Cd, H, W] query embedding, y_dist [B, Cd, H, W]
context embedding for the distances, y_val [B, Cv, H, W] context features,
radius r) to [B, Cv, H, W], with dist(p, q) over the (2r+1)^2 window as in
ops/local_pairwise.py (|y|^2 = 1e20 and y = 0 outside the image):

* sigmoid: sum_q 2 (1 - sigmoid(dist)) y_val(q) / k^2;
* softmax: weights softmax_q(1 / (dist * temp + 1e-5)), out-of-image
  positions kept in the denominator, sum_q w y_val(q) / k^2 (the
  reference's avgpool quirk);
* nearest: y_val at the window's argMAX of dist (the reference's quirk; an
  out-of-image position wins and gives 0), first occurrence in (dy, dx)
  order.

``valid_hw`` (every function): the true (rows, cols) of the maps inside a
width-bucketed buffer [.., H, W].  Positions at or beyond it are out of
image, as beyond the edge of an unpadded map (ops/local_pairwise.py), and
the output is zero there; on the valid region the result is the unpadded
run's.  The JAX package takes its XLA formulation when masked; the kernel
takes the valid size at run time.

A CPU tensor takes the plain version; a CUDA tensor launches
``kernels/csrc/local_agg.cu`` (the distances' dot products and the weighted
sum on the tensor cores at f32 accuracy: 3xTF32).
"""

from __future__ import annotations

import torch

from .. import kernels
from .local_pairwise import (local_pairwise_dist, local_weighted_aggregate,
                             local_window_gather, valid_region)

#: limits of the kernels' shared-memory staging and register tiles
#: (local_agg.cu)
MAX_RADIUS = 15
MAX_DIST_CHANNELS = 256


def _zero_band(t: torch.Tensor, valid_hw) -> torch.Tensor:
    """``t`` with zeros beyond ``valid_hw`` (a new tensor), or ``t``."""
    if valid_hw is None:
        return t
    return torch.where(valid_region(t, valid_hw), t, 0.0)


def local_sigmoid_aggregate_plain(x, y_dist, y_val, r: int, valid_hw=None):
    k = 2 * r + 1
    dist = local_pairwise_dist(x, y_dist, r, valid_hw)
    wts = 1.0 - (torch.sigmoid(dist) - 0.5) * 2.0
    out = local_weighted_aggregate(_zero_band(y_val, valid_hw), wts, r)
    return _zero_band(out / (k * k), valid_hw)


def local_softmax_aggregate_plain(x, y_dist, y_val, r: int,
                                  temp: float = 3.0, valid_hw=None):
    k = 2 * r + 1
    flat = local_pairwise_dist(x, y_dist, r, valid_hw).flatten(1, 2)
    wts = torch.softmax(1.0 / (flat * temp + 1e-5), dim=1)
    out = local_weighted_aggregate(_zero_band(y_val, valid_hw),
                                   wts.unflatten(1, (k, k)), r)
    return _zero_band(out / (k * k), valid_hw)


def local_nearest_aggregate_plain(x, y_dist, y_val, r: int, valid_hw=None):
    idx = torch.argmax(local_pairwise_dist(x, y_dist, r, valid_hw)
                       .flatten(1, 2), dim=1)                 # [B, H, W]
    windows = local_window_gather(_zero_band(y_val, valid_hw),
                                  r).flatten(2, 3)           # [B, C, k*k, H, W]
    idx = idx[:, None, None].expand(-1, windows.shape[1], 1, -1, -1)
    return _zero_band(torch.gather(windows, 2, idx)[:, :, 0], valid_hw)


def local_aggregate_flops(mode: str, b: int, h: int, w: int, cd: int,
                          cv: int, r: int) -> int:
    """f32 operations of one aggregation: the window's dot products over
    Cd channels and, but for ``nearest``, the weighted sum over Cv
    channels, 2 per multiply-add."""
    channels = cd if mode == "nearest" else cd + cv
    return 2 * b * h * w * (2 * r + 1) ** 2 * channels


def _valid_size(fn, x, valid_hw) -> tuple[int, int]:
    """(Hv, Wv) of a call: ``valid_hw``, or the whole grid; raises unless
    1 <= Hv <= H and 1 <= Wv <= W."""
    h, w = x.shape[-2:]
    if valid_hw is None:
        return h, w
    hv, wv = (int(v) for v in valid_hw)
    if not (1 <= hv <= h and 1 <= wv <= w):
        raise ValueError(f"{fn.__name__}: valid size {hv}x{wv} outside the "
                         f"{h}x{w} grid")
    return hv, wv


def _launch(fn, mode: str, x, y_dist, y_val, r: int, hv: int, wv: int,
            *extra):
    if x.device.type != "cuda":
        raise RuntimeError(f"no {fn.__name__} for device {x.device}")
    b, cd, h, w = x.shape
    cv = y_val.shape[1]
    if (y_dist.shape != x.shape or y_val.dim() != 4
            or y_val.shape[0] != b or y_val.shape[2:] != (h, w)):
        raise ValueError(f"{fn.__name__} takes x and y_dist [B, Cd, H, W] "
                         "and y_val [B, Cv, H, W]")
    if not 0 <= r <= MAX_RADIUS or not 1 <= cd <= MAX_DIST_CHANNELS:
        raise ValueError(f"{fn.__name__}: the kernel takes 0 <= r <= "
                         f"{MAX_RADIUS} and 1 <= Cd <= {MAX_DIST_CHANNELS}")
    kernels.check_inputs(fn.__name__, (x, y_dist, y_val))
    # the kernel writes every element, zeros beyond the valid size
    out = torch.empty(b, cv, h, w, device=x.device)
    entry = f"local_{mode}_agg_f32"
    kernels.check(kernels.entry(entry)(
        x.data_ptr(), y_dist.data_ptr(), y_val.data_ptr(), out.data_ptr(),
        b, cd, cv, h, w, hv, wv, r, *extra,
        kernels.stream(x.get_device())), entry)
    fn.launches += 1
    fn.flops += local_aggregate_flops(mode, b, h, w, cd, cv, r)
    return out


def local_sigmoid_aggregate(x, y_dist, y_val, r: int, valid_hw=None):
    """Sigmoid-weighted window mean (the default mode of our_warp)."""
    hv, wv = _valid_size(local_sigmoid_aggregate, x, valid_hw)
    if x.device.type == "cpu":
        return local_sigmoid_aggregate_plain(x, y_dist, y_val, r, valid_hw)
    return _launch(local_sigmoid_aggregate, "sigmoid", x, y_dist, y_val, r,
                   hv, wv)


def local_softmax_aggregate(x, y_dist, y_val, r: int, temp: float = 3.0,
                            valid_hw=None):
    """Inverse-distance softmax window aggregation (``--distsoftmax``)."""
    hv, wv = _valid_size(local_softmax_aggregate, x, valid_hw)
    if x.device.type == "cpu":
        return local_softmax_aggregate_plain(x, y_dist, y_val, r, temp,
                                             valid_hw)
    return _launch(local_softmax_aggregate, "softmax", x, y_dist, y_val, r,
                   hv, wv, float(temp))


def local_nearest_aggregate(x, y_dist, y_val, r: int, valid_hw=None):
    """y_val at the window's argmax distance (``--distnearest``)."""
    hv, wv = _valid_size(local_nearest_aggregate, x, valid_hw)
    if x.device.type == "cpu":
        return local_nearest_aggregate_plain(x, y_dist, y_val, r, valid_hw)
    return _launch(local_nearest_aggregate, "nearest", x, y_dist, y_val, r,
                   hv, wv)


#: each kernel's launches, and their f32 operations
#: (:func:`local_aggregate_flops`)
for _fn in (local_sigmoid_aggregate, local_softmax_aggregate,
            local_nearest_aggregate):
    _fn.launches = 0
    _fn.flops = 0

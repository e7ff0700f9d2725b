"""Why the tensor-core local aggregations (B5) split every operand: 3xTF32
against one TF32 product, emulated on the CPU.

``kernels/csrc/local_agg.cu`` runs both of its products on the tensor cores:
the distances' dot products <x_p, y_q> and the weighted sum of the window's
values.  Each f32 operand v is split into hi = tf32(v) and lo = tf32(v - hi)
(``kernels/csrc/mma_tf32.cuh``) and each product is lo*hi + hi*lo + hi*hi.
On the near-match inputs of ``local_agg_inputs`` (1x20x37, Cd 128, Cv 64,
r 10) both products taken that way keep the sigmoid and softmax
aggregations inside the card tests' bars against the f32 plain versions
(1e-5 + 1e-4 |want| per element, 1e-4 of the largest output), and one TF32
product each (what cuDNN's TF32 mode would give) misses them.  The kernels
themselves are held to their plain versions, and to a float64 evaluation, in
``tests/test_torch_cuda.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(__file__))
from cvpr2021_vspw_implement_tpu_torch.ops import local_agg  # noqa: E402
from cvpr2021_vspw_implement_tpu_torch.ops.local_pairwise import (  # noqa: E402
    local_pairwise_dist, local_weighted_aggregate)
from torch_port_util import (local_agg_inputs, tf32_products,  # noqa: E402
                             to_nchw)

R, TEMP = 10, 3.0


def _window_dots(x, y):
    """<x_p, y_q> over the window, [B, k, k, H, W] (0 outside the image)."""
    h, w = x.shape[-2:]
    k = 2 * R + 1
    yp = F.pad(y, (R, R, R, R))
    return torch.stack([torch.stack(
        [(x * yp[:, :, dy:dy + h, dx:dx + w]).sum(1) for dx in range(k)], 1)
        for dy in range(k)], 1)


def _emulated(mode, x, yd, yv, passes):
    """The aggregation with both products taken in TF32 (``passes`` 1 or
    3); everything else as the f32 plain version computes it."""
    k = 2 * R + 1
    dist = (local_pairwise_dist(x, yd, R) + 2.0 * _window_dots(x, yd)
            - 2.0 * tf32_products(_window_dots, x, yd, passes))
    if mode == "sigmoid":
        wts = 1.0 - (torch.sigmoid(dist) - 0.5) * 2.0
    else:
        wts = torch.softmax(1.0 / (dist.flatten(1, 2) * TEMP + 1e-5),
                            1).unflatten(1, (k, k))
    return tf32_products(lambda w, v: local_weighted_aggregate(v, w, R),
                         wts, yv, passes) / (k * k)


def _within_card_bars(got, want):
    err = (got - want).abs()
    return bool((err <= 1e-5 + 1e-4 * want.abs()).all()
                and err.max() <= 1e-4 * want.abs().max())


@pytest.mark.parametrize("mode", ["sigmoid", "softmax"])
def test_3xtf32_local_agg_within_card_bars(mode):
    x, yd, yv = (to_nchw(a) for a in local_agg_inputs(
        np.random.default_rng(17), 1, 20, 37, 128, 64))
    kw = {"temp": TEMP} if mode == "softmax" else {}
    want = getattr(local_agg, f"local_{mode}_aggregate_plain")(x, yd, yv, R,
                                                              **kw)
    assert _within_card_bars(_emulated(mode, x, yd, yv, 3), want)
    assert not _within_card_bars(_emulated(mode, x, yd, yv, 1), want)

"""Why the tensor-core GRU kernels split every operand: 3xTF32 against one
TF32 product, emulated on the CPU.

``kernels/csrc/tap_mma.cuh`` splits every f32 operand v into hi = tf32(v)
and lo = tf32(v - hi), each rounded as ``cvt.rna.tf32.f32`` rounds, and sums
lo*hi + hi*lo + hi*hi on the tensor cores.  On the GRU fixture (hd 128,
cx 256: K = 5 x 384 = 1920) the gate convolution with those products agrees
with the port's f32 plain convolution within 1e-5 abs, and one TF32 product
(what cuDNN's TF32 mode computes) is more than 10x further off: above the
1e-4 bars of the kernels' card tests.  The kernels themselves are held to
their plain versions, and to a float64 one, in ``tests/test_torch_cuda.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from cvpr2021_vspw_implement_tpu_torch.ops import sep_gru  # noqa: E402
from torch_port_util import (gru_inputs, port_gru_args,  # noqa: E402
                             tf32_products)


@pytest.mark.parametrize("axis", [0, 1])
def test_3xtf32_gate_conv_matches_f32(axis):
    rng = np.random.default_rng(10 + axis)
    h, x, wzr, bzr, _, _ = port_gru_args(
        *gru_inputs(rng, 1, 6, 9, 128, 256, axis))
    hx = torch.cat([h, x], 1)

    def conv(a, w):
        return sep_gru._conv(a, w, None, axis)

    want = sep_gru._conv(hx, wzr, bzr, axis)            # the f32 plain gate
    err3 = (tf32_products(conv, hx, wzr, 3) + bzr[:, None, None]
            - want).abs().max().item()
    err1 = (tf32_products(conv, hx, wzr, 1) + bzr[:, None, None]
            - want).abs().max().item()
    assert err3 <= 1e-5, err3
    assert err1 > 10 * err3, (err1, err3)

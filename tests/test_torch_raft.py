"""Port RAFT (test mode) against the JAX RAFT with the same weights.

Weights go JAX → port through ``convert.load_jax_variables``; the port's
``state_dict()`` read back through the JAX importer
(``import_raft_state_dict``) must give the same Flax tree.  Flow tolerance
atol 1e-3 px: f32 on both sides, three refinements of summed-order
differences, and the flow is in pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2021_vspw_implement_tpu.models.import_torch import \
    import_raft_state_dict
from cvpr2021_vspw_implement_tpu.models.raft import RAFT as JaxRAFT
from cvpr2021_vspw_implement_tpu.models.raft import \
    pad_to_multiple_of_8 as jax_pad
from cvpr2021_vspw_implement_tpu.models.raft.raft import \
    upsample_flow_convex as jax_upsample
from cvpr2021_vspw_implement_tpu.tc_cal import load_raft_variables
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.models.raft import (
    RAFT, pad_to_multiple_of_8, unpad, upsample_flow_convex)
from torch_port_util import (assert_trees_equal, perturb_batchnorm, to_nchw,
                             to_nhwc)

ITERS = 3


@pytest.fixture(scope="module")
def raft_pair():
    jmodel = JaxRAFT(iters=ITERS)
    variables = perturb_batchnorm(load_raft_variables("", jmodel), seed=5)
    # the random init moves the flow ~20 px per refinement, where a trained
    # RAFT moves a few; at that step size each iteration amplifies f32
    # rounding ~8x, so the flow head is scaled to a trained-like step
    variables["params"]["update_block"]["flow_head"]["conv2"]["conv"][
        "kernel"] *= 0.1
    port = load_jax_variables(RAFT(iters=ITERS), variables).eval()
    return jmodel, variables, port


def test_raft_flow_matches_jax(raft_pair):
    jmodel, variables, port = raft_pair
    rng = np.random.default_rng(0)
    im1 = rng.uniform(0, 255, (1, 45, 61, 3)).astype(np.float32)
    im2 = np.roll(im1, (1, 2), axis=(1, 2)) + rng.normal(
        0, 4, im1.shape).astype(np.float32)
    p1, pads = jax_pad(jnp.asarray(im1))
    p2, _ = jax_pad(jnp.asarray(im2))
    assert p1.shape[1:3] == (48, 64)
    with jax.default_matmul_precision("highest"):
        low_j, up_j = jmodel.apply(variables, p1, p2, test_mode=True)

    t1, tpads = pad_to_multiple_of_8(to_nchw(im1))
    t2, _ = pad_to_multiple_of_8(to_nchw(im2))
    assert tpads == pads
    np.testing.assert_array_equal(to_nhwc(t1), np.asarray(p1))
    with torch.inference_mode():
        low_t, up_t = port(t1, t2)
    np.testing.assert_allclose(to_nhwc(low_t), np.asarray(low_j), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(to_nhwc(up_t), np.asarray(up_j), atol=1e-3,
                               rtol=0)
    assert unpad(up_t, tpads).shape[-2:] == (45, 61)


def test_upsample_flow_convex_matches_jax():
    rng = np.random.default_rng(1)
    flow = rng.normal(size=(2, 5, 7, 2)).astype(np.float32)
    mask = rng.normal(size=(2, 5, 7, 576)).astype(np.float32)
    want = np.asarray(jax_upsample(jnp.asarray(flow), jnp.asarray(mask)))
    got = to_nhwc(upsample_flow_convex(to_nchw(flow), to_nchw(mask)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_raft_state_dict_round_trip(raft_pair):
    _, variables, port = raft_pair
    back = import_raft_state_dict(port.state_dict())
    assert_trees_equal(back["params"], variables["params"])
    assert_trees_equal(back["batch_stats"], variables["batch_stats"])

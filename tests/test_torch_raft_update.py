"""The fused RAFT-update wrappers of the port against the JAX package.

* ``motion_encoder_plain`` / ``gru_flowhead_plain`` (the kernels' oracles
  and CPU paths) against ``motion_encoder_xla`` / ``gru_flowhead_xla``
  (atol 1e-5: the same f32 convolutions, summed in another order) and
  against the Pallas kernels in interpret mode (atol/rtol 8e-5, the bar of
  tests/test_pallas_raft_update.py);
* the update block takes the fused pair up to 4096 positions and the
  row-tiled GRU pass above, on both sides;
* RAFT flow through the fused route equals the unfused route and the JAX
  flow (atol 1e-3 px, the bar of tests/test_torch_raft.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2021_vspw_implement_tpu.models.raft import RAFT as JaxRAFT
from cvpr2021_vspw_implement_tpu.models.raft.update import \
    BasicUpdateBlock as JaxUpdateBlock
from cvpr2021_vspw_implement_tpu.ops.pallas import gru as jax_gru
from cvpr2021_vspw_implement_tpu.ops.pallas import raft_update as jax_ru
from cvpr2021_vspw_implement_tpu.tc_cal import load_raft_variables
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.models.raft import RAFT
from cvpr2021_vspw_implement_tpu_torch.models.raft import update as port_update
from cvpr2021_vspw_implement_tpu_torch.ops.gru_flowhead import (
    gru_flowhead, gru_flowhead_plain)
from cvpr2021_vspw_implement_tpu_torch.ops.motion_encoder import (
    motion_encoder, motion_encoder_plain)
from torch_port_util import (gru_flowhead_inputs, motion_inputs,
                             perturb_batchnorm, port_gru_flowhead_weights,
                             port_motion_weights, to_nchw, to_nhwc)

SIZES = [(12, 16), (9, 13)]


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("oracle", ["xla", "pallas"])
def test_motion_encoder_plain_matches_jax(hw, oracle):
    corr, flow, p = motion_inputs(np.random.default_rng(0), 2, *hw)
    got = motion_encoder_plain(to_nchw(corr), to_nchw(flow),
                               port_motion_weights(p))
    assert got.shape == (2, 128, *hw)
    if oracle == "xla":
        want, tol = jax_ru.motion_encoder_xla(corr, flow, p), (1e-5, 0)
    else:
        want = jax_ru.motion_encoder_fused(jnp.asarray(corr),
                                           jnp.asarray(flow), p,
                                           interpret=True)
        tol = (8e-5, 8e-5)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=tol[0],
                               rtol=tol[1])
    # a CPU tensor takes the plain version and counts no launch
    before = motion_encoder.launches
    torch.testing.assert_close(
        motion_encoder(to_nchw(corr), to_nchw(flow), port_motion_weights(p)),
        got, rtol=0, atol=0)
    assert motion_encoder.launches == before


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("oracle", ["xla", "pallas"])
def test_gru_flowhead_plain_matches_jax(hw, oracle):
    net, x, p = gru_flowhead_inputs(np.random.default_rng(1), 2, *hw,
                                    hd=32, cx=64)
    weights = port_gru_flowhead_weights(p)
    got_net, got_delta = gru_flowhead_plain(to_nchw(net), to_nchw(x), weights)
    assert got_delta.shape == (2, 2, *hw)
    if oracle == "xla":
        want, tol = jax_ru.gru_flowhead_xla(net, x, p), (1e-5, 0)
    else:
        want = jax_ru.gru_flowhead_fused(jnp.asarray(net), jnp.asarray(x), p,
                                         interpret=True)
        tol = (8e-5, 8e-5)
    for i, (name, out) in enumerate((("net", got_net), ("delta", got_delta))):
        _assert_close_naming_side(
            to_nhwc(out), np.asarray(want[i]), tol, name,
            lambda i=i: gru_flowhead_plain(
                to_nchw(net).double(), to_nchw(x).double(),
                {k: (w.double(), b.double())
                 for k, (w, b) in weights.items()})[i])
    before = gru_flowhead.launches
    same = gru_flowhead(to_nchw(net), to_nchw(x), weights)
    torch.testing.assert_close(same[1], got_delta, rtol=0, atol=0)
    assert gru_flowhead.launches == before


def _assert_close_naming_side(got, want, tol, name, float64):
    """assert_allclose(got, want); when the bar is missed, the message also
    gives each side's largest error against ``float64()`` (the same function
    evaluated in float64 on the same inputs, NCHW), so that it says which
    side moved."""
    try:
        np.testing.assert_allclose(got, want, atol=tol[0], rtol=tol[1])
    except AssertionError as e:
        ref = to_nhwc(float64())
        port_err = np.abs(got - ref).max()
        jax_err = np.abs(want - ref).max()
        side = "the port" if port_err > jax_err else "JAX"
        raise AssertionError(
            f"{name}: port vs float64 {port_err:.3e}, JAX vs float64 "
            f"{jax_err:.3e}; {side} moved\n{e}") from None


@pytest.fixture(scope="module")
def raft_pair():
    jmodel = JaxRAFT(iters=3)
    variables = perturb_batchnorm(load_raft_variables("", jmodel), seed=5)
    # a trained-like step size (see tests/test_torch_raft.py)
    variables["params"]["update_block"]["flow_head"]["conv2"]["conv"][
        "kernel"] *= 0.1
    port = load_jax_variables(RAFT(iters=3), variables).eval()
    return jmodel, variables, port


@pytest.mark.parametrize("hw,fused", [((64, 64), True), ((64, 65), False)])
def test_update_block_dispatch_matches_jax(raft_pair, monkeypatch, hw, fused):
    """Both sides of the 4096-position gate: the routes taken, and the
    results (atol 1e-4 on net in [-1, 1] and delta)."""
    _, variables, port = raft_pair
    assert port_update.FUSED_MAX_POSITIONS == 4096
    rng = np.random.default_rng(2)
    h, w = hw
    net = np.tanh(rng.normal(size=(1, h, w, 128))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(1, h, w, 128)), 0).astype(np.float32)
    corr = rng.normal(size=(1, h, w, 324)).astype(np.float32)
    flow = rng.normal(0, 2, size=(1, h, w, 2)).astype(np.float32)

    # the JAX block as it dispatches off the CPU, with each TPU kernel
    # replaced by its XLA formulation and counted
    calls = {"fused": 0, "gru_pass": 0}

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_ru, "motion_encoder_fused",
                        counted("fused", jax_ru.motion_encoder_xla))
    monkeypatch.setattr(jax_ru, "gru_flowhead_fused",
                        counted("fused", jax_ru.gru_flowhead_xla))
    monkeypatch.setattr(jax_gru, "sep_conv_gru_pass",
                        counted("gru_pass", jax_gru.sep_conv_gru_pass_xla))
    want_net, _, want_delta = JaxUpdateBlock().apply(
        {"params": variables["params"]["update_block"]}, jnp.asarray(net),
        jnp.asarray(inp), jnp.asarray(corr), jnp.asarray(flow),
        with_mask=False)
    assert calls == ({"fused": 2, "gru_pass": 0} if fused
                     else {"fused": 0, "gru_pass": 2})

    port_calls = {"fused": 0, "gru_pass": 0}
    for name, key in (("motion_encoder", "fused"), ("gru_flowhead", "fused"),
                      ("sep_conv_gru_pass", "gru_pass")):
        fn = getattr(port_update, name)

        def wrapper(*a, _fn=fn, _key=key):
            port_calls[_key] += 1
            return _fn(*a)
        monkeypatch.setattr(port_update, name, wrapper)
    with torch.inference_mode():
        got_net, got_delta = port.update_block(
            to_nchw(net), to_nchw(inp), to_nchw(corr), to_nchw(flow),
            port.update_block.taps())
    assert port_calls == calls
    np.testing.assert_allclose(to_nhwc(got_net), np.asarray(want_net),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(to_nhwc(got_delta), np.asarray(want_delta),
                               atol=1e-4, rtol=0)


def test_raft_fused_route_matches_unfused_and_jax(raft_pair, monkeypatch):
    jmodel, variables, port = raft_pair
    rng = np.random.default_rng(3)
    im1 = rng.uniform(0, 255, (2, 48, 64, 3)).astype(np.float32)
    im2 = np.roll(im1, (1, 2), axis=(1, 2)) + rng.normal(
        0, 4, im1.shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        _, want = jmodel.apply(variables, jnp.asarray(im1), jnp.asarray(im2),
                               test_mode=True)
    with torch.inference_mode():
        _, fused = port(to_nchw(im1), to_nchw(im2))
        monkeypatch.setattr(port_update, "FUSED_MAX_POSITIONS", 0)
        _, unfused = port(to_nchw(im1), to_nchw(im2))
    np.testing.assert_allclose(to_nhwc(fused), np.asarray(want), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(to_nhwc(fused), to_nhwc(unfused), atol=1e-3,
                               rtol=0)


@pytest.mark.parametrize("which", ["motion_encoder", "gru_flowhead"])
def test_wrappers_refuse_other_devices(which):
    """Only a CPU tensor takes the plain version; a tensor anywhere else
    but on a CUDA device raises."""
    if which == "motion_encoder":
        corr, flow, p = motion_inputs(np.random.default_rng(4), 1, 4, 5)
        args = (to_nchw(corr).to("meta"), to_nchw(flow).to("meta"),
                port_motion_weights(p))
        fn = motion_encoder
    else:
        net, x, p = gru_flowhead_inputs(np.random.default_rng(4), 1, 4, 5,
                                        hd=8, cx=8)
        args = (to_nchw(net).to("meta"), to_nchw(x).to("meta"),
                port_gru_flowhead_weights(p))
        fn = gru_flowhead
    with pytest.raises(RuntimeError, match="for device meta"):
        fn(*args)


def test_library_name_follows_shared_headers(tmp_path, monkeypatch):
    """The sources share device code through csrc/*.cuh: an edited header
    must give every library a new name, or a stale build would be loaded."""
    import shutil

    from cvpr2021_vspw_implement_tpu_torch import kernels
    assert set(kernels.SIGNATURES) == {"corr_lookup", "sep_gru",
                                       "motion_encoder", "gru_flowhead",
                                       "local_agg", "local_agg_bwd",
                                       "band_zero"}
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    before = {n: kernels.library_path(n) for n in kernels.SIGNATURES}
    assert before == {n: kernels.library_path(n) for n in kernels.SIGNATURES}
    with open(csrc / "tap_mma.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: kernels.library_path(n) for n in kernels.SIGNATURES}
    assert all(after[n] != before[n] for n in before)
    with open(csrc / "sep_gru.cu", "a") as f:
        f.write("// edited\n")
    assert kernels.library_path("sep_gru") != after["sep_gru"]
    assert kernels.library_path("corr_lookup") == after["corr_lookup"]
    for name in kernels.SIGNATURES:
        assert (csrc / (name + ".cu")).exists()

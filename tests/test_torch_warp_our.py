"""Port our_warp (the three B5 aggregations, their cost-volume ops and the
ClipWarpNet eval forward) against the JAX package.

* plain B5 sigmoid/softmax/nearest vs JAX ``warp_one_scale`` over
  ``local_pairwise_dist`` (the XLA path) and vs the Pallas kernels in
  interpret mode: atol 1e-5, rtol 1e-4 (f32, sums in another order).  The
  inputs are N(0, 0.3^2), so 1 / (dist * temp + 1e-5) stays away from its
  pole.  Sigmoid and softmax again on near-match inputs whose window weights
  are far from uniform, also within 1e-4 of the largest output.  Nearest
  must pick the same value except where the two largest window distances
  are in the image and lie within 1e-4 relative (a near-tie that rounding
  may flip);
* ``local_pairwise_dist``, ``local_weighted_aggregate`` and
  ``local_window_gather`` vs the JAX ones;
* the ResNet-18 ClipWarpNet eval logits vs JAX in all four modes of
  tests/test_warp_our.py and with two scales, within 1e-4 of the logits'
  range, with perturbed BatchNorm statistics;
* the ``state_dict`` round trip through ``import_clip_warp_state_dict``
  (exact); training in each mode (its outputs, its loss's gradients, the
  method's loss registered), and the refusal of training with a valid size.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2021_vspw_implement_tpu.models.builder import ModelBuilder
from cvpr2021_vspw_implement_tpu.models.import_torch import \
    import_clip_warp_state_dict
from cvpr2021_vspw_implement_tpu.models.warp_our import \
    ClipWarpNet as JaxClipWarpNet
from cvpr2021_vspw_implement_tpu.models.warp_our import \
    warp_one_scale as jax_warp_one_scale
from cvpr2021_vspw_implement_tpu.ops import local_pairwise as jlp
from cvpr2021_vspw_implement_tpu.ops.pallas import local_agg as jpallas
from cvpr2021_vspw_implement_tpu_torch import methods
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.models.resnet import build_encoder
from cvpr2021_vspw_implement_tpu_torch.models.warp_our import (
    ClipWarpNet, clip_warp_loss)
from cvpr2021_vspw_implement_tpu_torch.ops import local_agg, local_pairwise
from torch_port_util import (assert_trees_equal, local_agg_inputs,
                             perturb_batchnorm, to_nchw, to_nhwc)

MODES = ("sigmoid", "softmax", "nearest")
# (B, H, W, Cd, Cv, r): ragged widths, both batch sizes, Cd != Cv
CASES = [(1, 5, 7, 6, 10, 1), (2, 8, 10, 5, 9, 3), (1, 8, 10, 8, 4, 2),
         (2, 5, 7, 7, 12, 2)]
GAP = 1e-4


def _inputs(seed, b, h, w, cd, cv):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((b, h, w, cd))).astype(np.float32)
    yd = (0.3 * rng.standard_normal((b, h, w, cd))).astype(np.float32)
    yv = rng.standard_normal((b, h, w, cv)).astype(np.float32)
    return x, yd, yv


def _near_ties(dist):
    """[B, H, W] mask of positions whose two largest window distances are
    in the image and lie within GAP relative (dist: JAX [B, H, W, k, k]).
    Out-of-image positions all hold the same value, so among them the first
    one wins on every side."""
    flat = np.sort(np.asarray(dist).reshape(*dist.shape[:3], -1), -1)
    return ((flat[..., -1] < 1e19)
            & (flat[..., -1] - flat[..., -2] <= GAP * np.abs(flat[..., -1])))


def _port(mode, x, yd, yv, r):
    fn = getattr(local_agg, f"local_{mode}_aggregate")
    return to_nhwc(fn(to_nchw(x), to_nchw(yd), to_nchw(yv), r))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "b{}_{}x{}_cd{}_cv{}_r{}"
                         .format(*c))
@pytest.mark.parametrize("mode", MODES)
def test_plain_b5_matches_jax_xla_and_pallas(mode, case):
    b, h, w, cd, cv, r = case
    x, yd, yv = _inputs(sum(case), b, h, w, cd, cv)
    dist = jlp.local_pairwise_dist(jnp.asarray(x), jnp.asarray(yd), r)
    xla = np.asarray(jax_warp_one_scale(
        dist, jnp.asarray(yv), r, distsoftmax=mode == "softmax",
        distnearest=mode == "nearest", temp=3.0, emb_dim=cv))
    kw = {"temp": 3.0} if mode == "softmax" else {}
    pallas = np.asarray(getattr(jpallas, f"local_{mode}_aggregate")(
        jnp.asarray(x), jnp.asarray(yd), jnp.asarray(yv), r, interpret=True,
        **kw))
    got = _port(mode, x, yd, yv, r)
    assert got.shape == (b, h, w, cv)
    if mode == "nearest":
        keep = ~_near_ties(dist)
        assert keep.mean() > 0.9
        np.testing.assert_array_equal(got[keep], xla[keep])
        np.testing.assert_array_equal(got[keep], pallas[keep])
    else:
        np.testing.assert_allclose(got, xla, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", [(1, 8, 10, 6, 9, 2), (2, 5, 7, 8, 4, 3)],
                         ids=lambda c: "b{}_{}x{}_cd{}_cv{}_r{}".format(*c))
@pytest.mark.parametrize("mode", ["sigmoid", "softmax"])
def test_plain_b5_far_from_uniform_matches_jax(mode, case):
    b, h, w, cd, cv, r = case
    x, yd, yv = local_agg_inputs(np.random.default_rng(sum(case)), b, h, w,
                                 cd, cv, scale=0.3)
    dist = jlp.local_pairwise_dist(jnp.asarray(x), jnp.asarray(yd), r)
    xla = np.asarray(jax_warp_one_scale(
        dist, jnp.asarray(yv), r, distsoftmax=mode == "softmax",
        distnearest=False, temp=3.0, emb_dim=cv))
    kw = {"temp": 3.0} if mode == "softmax" else {}
    pallas = np.asarray(getattr(jpallas, f"local_{mode}_aggregate")(
        jnp.asarray(x), jnp.asarray(yd), jnp.asarray(yv), r, interpret=True,
        **kw))
    got = _port(mode, x, yd, yv, r)
    for want in (xla, pallas):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("r", [1, 3])
def test_local_pairwise_ops_match_jax(r):
    b, h, w, c = 2, 6, 9, 5
    x, y, _ = _inputs(r, b, h, w, c, 1)
    k = 2 * r + 1
    want = np.asarray(jlp.local_pairwise_dist(jnp.asarray(x), jnp.asarray(y),
                                              r))                  # [B,H,W,k,k]
    got = np.moveaxis(local_pairwise.local_pairwise_dist(
        to_nchw(x), to_nchw(y), r).numpy(), (1, 2), (3, 4))
    inb = want < 1e19
    assert 0 < inb.mean() < 1
    np.testing.assert_allclose(got[inb], want[inb], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[~inb], want[~inb])

    wts = np.random.default_rng(r).random((b, h, w, k, k), np.float32)
    want = np.asarray(jlp.local_weighted_aggregate(jnp.asarray(y),
                                                   jnp.asarray(wts), r))
    got = to_nhwc(local_pairwise.local_weighted_aggregate(
        to_nchw(y), torch.from_numpy(np.moveaxis(wts, (3, 4), (1, 2)).copy()),
        r))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    for pad in (0.0, 7.0):
        want = np.asarray(jlp.local_window_gather(jnp.asarray(y), r, pad))
        got = local_pairwise.local_window_gather(to_nchw(y), r, pad).numpy()
        # [B, C, k, k, H, W] → [B, H, W, k, k, C]
        np.testing.assert_array_equal(
            np.transpose(got, (0, 4, 5, 2, 3, 1)), want)


K, T, H, W = 5, 4, 64, 80
MODEL_MODES = {
    "sigmoid": {}, "softmax": {"distsoftmax": True},
    "nearest": {"distnearest": True}, "linear": {"linear_combine": True},
    "two_scales": {"max_distances": [1, 3]},
}


def _args(**kw):
    ns = argparse.Namespace(fix=False, max_distances=[2], linear_combine=False,
                            distsoftmax=False, distnearest=False, temp=3.0)
    for key, v in kw.items():
        setattr(ns, key, v)
    return ns


def _pcfg():
    cfg = port_default_cfg.clone()
    cfg.MODEL.arch_encoder = "resnet18dilated"
    cfg.MODEL.fc_dim = 512
    return cfg


def _models(mode):
    args = _args(**MODEL_MODES[mode])
    jmodel = JaxClipWarpNet(encoder=ModelBuilder.build_encoder(
        "resnet18dilated"), num_class=K, fc_dim=512, args=args)
    key = jax.random.PRNGKey(1)
    v = jmodel.init({"params": key, "dropout": key},
                    jnp.zeros((T, 1, H, W, 3), jnp.float32), train=True)
    variables = perturb_batchnorm(
        {"params": v["params"], "batch_stats": v["batch_stats"]}, seed=6)
    if mode == "linear":      # blend weights away from their init
        rng = np.random.default_rng(8)
        for i in range(T):
            variables["params"]["prop_clip"][f"w{i}"] = rng.uniform(
                0.2, 1.5, 256).astype(np.float32)
    port = ClipWarpNet(build_encoder("resnet18dilated"), K, fc_dim=512,
                       clip_num=T, max_distances=args.max_distances,
                       linear_combine=args.linear_combine,
                       distsoftmax=args.distsoftmax,
                       distnearest=args.distnearest, temp=args.temp)
    return jmodel, variables, load_jax_variables(port, variables).eval()


@pytest.mark.parametrize("mode", list(MODEL_MODES))
def test_clip_warp_net_logits_match_jax(mode):
    jmodel, variables, port = _models(mode)
    imgs = np.random.default_rng(9).normal(size=(T, 1, H, W, 3)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmodel.apply(variables, jnp.asarray(imgs),
                                       train=False)[0])
    with torch.inference_mode():
        got = to_nhwc(port(to_nchw(imgs))[0])
    assert got.shape == want.shape == (1, H // 8, W // 8, K)
    scale = want.max() - want.min()
    assert np.abs(got - want).max() <= 1e-4 * scale


def test_clip_warp_state_dict_round_trip():
    _, variables, port = _models("linear")
    names = set(port.state_dict())
    assert {"prop_clip.emb.0.weight", "prop_clip.emb_2.1.running_var",
            "prop_clip.w3", "prop_clip.last_layer.1.bias",
            "last_layer.1.weight"} <= names
    assert_trees_equal(import_clip_warp_state_dict(port.state_dict()),
                       variables)


def test_our_warp_training_is_refused():
    """Training runs now (B5's explicit backward), in each mode; what is
    still refused is training width-bucketed, with a valid size: the masked
    paths are eval only, as in JAX.  The training outputs' shapes, and the
    loss's gradient reaching both embeddings and the encoder."""
    for mode in ("sigmoid", "softmax", "nearest"):
        _check_training(mode)
    assert methods.build_method("our_warp", _pcfg(), _args(
        num_class=K, clip_num=T))[1] is not None


def _check_training(mode):
    _, _, port = _models(mode)
    port.train()
    imgs = torch.from_numpy(np.random.default_rng(3).normal(
        size=(T, 2, 3, H, W)).astype(np.float32))
    outs = port(imgs)
    assert set(outs) == {"pred", "deepsup", "allsup"}
    assert outs["pred"].shape == (2, K, H // 8, W // 8)
    assert outs["deepsup"].shape == outs["allsup"].shape == (
        2 * T, K, H // 8, W // 8)
    labels = torch.from_numpy(np.random.default_rng(4).integers(
        0, K, (T, 2, H, W)))
    loss, acc = clip_warp_loss(outs, {"labels": labels}, allsup=True)
    loss.backward()
    assert torch.isfinite(loss) and 0 <= acc <= 1
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert grads["prop_clip.emb.0.weight"].abs().max() > 0
    assert grads["encoder.conv1.weight"].abs().max() > 0
    # emb_2 also feeds the all-frame head: the warp's own part is checked
    # in tests/test_torch_local_agg_grad.py
    assert grads["prop_clip.emb_2.0.weight"].abs().max() > 0
    with pytest.raises(ValueError):
        port(torch.zeros(T, 1, 3, H + 8, W + 8), valid_hw=(H, W))

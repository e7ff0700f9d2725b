"""PropNet and our_warp_merge of the port against the JAX package, exact
and width-bucketed, f32 on the CPU.

ResNet-18-dilated, fc_dim 512, 5 classes, r = 2; a seeded port init with
BatchNorm statistics perturbed, carried to JAX through
``import_propnet_state_dict`` and ``import_warp_merge_state_dict``; JAX's
side jitted.  Frames of 48x72 go into the 64x128 bucket (features 8x16,
valid 6x9).

* ``prop_pred``: its scatter form against JAX ``prop_pred`` given the same
  distances and the same sigmoid, exactly (a minimum does not depend on
  order), with and without a valid size; and as it stands, its distances
  summed in another order, within 1e-6;
* the models, exact and bucketed, against JAX ``model.apply`` (logits
  within 1e-4 of their range), bucketed against exact, and the
  ``state_dict`` against the JAX variable tree's layout;
* ``test_clip --method propnet`` / ``our_warp_merge`` with the default
  ``--width_bucket 64`` against the JAX CLI: identical PNGs, equal mIoU
  and VC;
* both train (outputs, loss and gradients), but not width-bucketed.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2021_vspw_implement_tpu.methods import build_method as jax_build
from cvpr2021_vspw_implement_tpu.models import propnet as jax_propnet
from cvpr2021_vspw_implement_tpu.models.import_torch import (
    import_propnet_state_dict, import_warp_merge_state_dict)
from cvpr2021_vspw_implement_tpu.test_clip import evaluate_clip
from cvpr2021_vspw_implement_tpu_torch import test_clip
from cvpr2021_vspw_implement_tpu_torch.methods import build_method
from cvpr2021_vspw_implement_tpu_torch.models import propnet
from cvpr2021_vspw_implement_tpu_torch.models.layers import init_weights
from cvpr2021_vspw_implement_tpu_torch.ops import masked
from cvpr2021_vspw_implement_tpu_torch.ops.local_pairwise import \
    local_pairwise_dist
from test_torch_window_bucketed import (PAD, PRESET, H, K, W, _cfgs,
                                        _jax_args, _window, assert_same_pngs)
from test_torch_window_bucketed import root  # noqa: F401 (fixture)
from torch_port_util import (flatten, numpy_tree, perturb_port_batchnorm,
                             to_nchw, to_nhwc)

IMPORTERS = {"propnet": import_propnet_state_dict,
             "our_warp_merge": import_warp_merge_state_dict}


# prop_pred

def _prop_inputs(seed, b=2, h=8, w=16, c=12):
    rng = np.random.default_rng(seed)
    prev = (0.3 * rng.standard_normal((b, h, w, c))).astype(np.float32)
    query = (0.3 * rng.standard_normal((b, h, w, c))).astype(np.float32)
    labels = rng.integers(0, K, (b, h, w)).astype(np.int32)
    return prev, query, labels


@pytest.mark.parametrize("valid", [None, (6, 9), (8, 11)])
def test_prop_pred_scatter_matches_jax_exactly(monkeypatch, valid):
    """JAX's masked window minimum, fed the port's distances and squashed
    by the port's sigmoid (XLA's and torch's differ in the last bit), gives
    the port's scatter form bit for bit."""
    prev, query, labels = _prop_inputs(0)
    r = 2
    dist = local_pairwise_dist(to_nchw(query), to_nchw(prev), r,
                               valid_hw=valid)           # [B, k, k, h, w]
    monkeypatch.setattr(jax_propnet, "local_pairwise_dist",
                        lambda *a, **kw: jnp.asarray(
                            dist.permute(0, 3, 4, 1, 2).numpy()))
    monkeypatch.setattr(jax.nn, "sigmoid", lambda x: jnp.asarray(
        torch.sigmoid(torch.from_numpy(np.array(x))).numpy()))
    want = np.asarray(jax_propnet.prop_pred(
        jnp.asarray(prev), jnp.asarray(query), jnp.asarray(labels), r, K,
        feat_valid=valid))
    got = to_nhwc(propnet.prop_pred(to_nchw(prev), to_nchw(query),
                                    torch.from_numpy(labels), r, K, valid))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= -1.0 and got.max() == 1.0


@pytest.mark.parametrize("valid", [None, (6, 9)])
def test_prop_pred_matches_jax(valid):
    prev, query, labels = _prop_inputs(1)
    want = np.asarray(jax_propnet.prop_pred(
        jnp.asarray(prev), jnp.asarray(query), jnp.asarray(labels), 3, K,
        feat_valid=valid))
    got = to_nhwc(propnet.prop_pred(to_nchw(prev), to_nchw(query),
                                    torch.from_numpy(labels), 3, K, valid))
    hv, wv = valid or got.shape[1:3]
    np.testing.assert_allclose(got[:, :hv, :wv], want[:, :hv, :wv],
                               atol=1e-6, rtol=0)


# the models

def _models(method, **opts):
    cfg, pcfg = _cfgs()
    args = _jax_args(method=method, **opts)
    jmodel, _ = jax_build(method, cfg, args)
    port, _ = build_method(method, pcfg, args)
    init_weights(port, torch.Generator().manual_seed(0))
    perturb_port_batchnorm(port, 2)
    return (cfg, args, jmodel, IMPORTERS[method](port.state_dict()),
            port.eval())


RUNS = {"propnet": ("propnet", {}), "our_warp_merge": ("our_warp_merge", {}),
        "our_warp_merge_softmax": ("our_warp_merge", {"distsoftmax": True}),
        "our_warp_merge_nearest": ("our_warp_merge", {"distnearest": True})}


@pytest.mark.parametrize("run", list(RUNS))
def test_model_exact_and_bucketed_match_jax(run):
    method, opts = RUNS[run]
    _, _, jmodel, variables, port = _models(method, **opts)
    imgs = _window(5, 4)
    padded = np.zeros(imgs.shape[:2] + PAD + (3,), np.float32)
    padded[:, :, :H, :W] = imgs
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, x: jmodel.apply(
            v, x, train=False)[0])(variables, jnp.asarray(imgs)))
        want_b = np.asarray(jax.jit(lambda v, x: jmodel.apply(
            v, x, train=False, valid_hw=(H, W))[0])(
                variables, jnp.asarray(padded)))
    with torch.inference_mode():
        got = to_nhwc(port(to_nchw(imgs))[0])
        got_b = port(torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(padded, -1, 2))), valid_hw=(H, W))[0]
    hv, wv = masked.feature_valid(*got_b.shape[-2:], (H, W), PAD)
    assert got.shape == want.shape == (1, hv, wv, K) == (1, 6, 9, K)
    got_b, want_b = to_nhwc(got_b)[:, :hv, :wv], want_b[:, :hv, :wv]
    scale = want.max() - want.min()
    assert np.abs(got - want).max() <= 1e-4 * scale
    assert np.abs(got_b - want_b).max() <= 1e-4 * scale
    assert np.abs(got_b - got).max() <= 1e-4 * scale


@pytest.mark.parametrize("method", list(IMPORTERS))
def test_state_dict_matches_jax_layout(method):
    """The port's parameters and statistics, through the JAX importer, give
    exactly the JAX model's variable tree (names and shapes)."""
    _, args, jmodel, variables, _ = _models(method)
    init = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((args.clip_num, 1, 64, 64, 3), jnp.float32), train=True))
    init = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape),
        {"params": init["params"], "batch_stats": init["batch_stats"]})
    want = {k: v.shape for k, v in flatten(init).items()}
    got = {k: v.shape for k, v in flatten(numpy_tree(variables)).items()}
    assert got == want


@pytest.mark.parametrize("method", list(IMPORTERS))
def test_cli_bucketed_matches_jax(root, tmp_path, method):  # noqa: F811
    cfg, args, _, variables, port = _models(method)
    for key, v in dict(dataroot=root, split="val", vc_clip_num=8,
                       lesslabel=False, load="", is_save=True,
                       saveroot=str(tmp_path / "jax"),
                       width_bucket=64).items():
        setattr(args, key, v)
    with jax.default_matmul_precision("highest"):
        jm, _ = evaluate_clip(cfg, args, variables=variables, is_save=True)
    ckpt = str(tmp_path / "model.pth")
    torch.save(port.state_dict(), ckpt)
    pm, _ = test_clip.main([
        "--cfg", PRESET, "--dataroot", root, "--num_class", str(K),
        "--method", method, "--max_distances", "2", "--load", ckpt,
        "--is_save", "--saveroot", str(tmp_path / "port"), "--device",
        "cpu"])
    assert_same_pngs(str(tmp_path / "port" / "video_000"),
                     str(tmp_path / "jax" / "video_000"))
    assert pm["mIoU"] == pytest.approx(jm["mIoU"], abs=1e-12)
    assert pm["VC"] == pytest.approx(jm["VC"], abs=1e-12)


@pytest.mark.parametrize("method", list(IMPORTERS))
def test_training_is_refused(method):
    """Training runs now (propnet through its plain distances,
    our_warp_merge through B5's explicit backward); what is still refused
    is training width-bucketed, with a valid size, as in JAX.  The
    training outputs' shapes and the registered loss's gradients reaching
    the method's head and the encoder."""
    _, args, _, _, port = _models(method)
    port.train()
    imgs = torch.from_numpy(_window(5, 4).transpose(0, 1, 4, 2, 3).copy())
    outs = port(imgs)
    h, w = H // 8, W // 8
    assert outs["pred_s"].shape == outs["deepsup"].shape == (4, K, h, w)
    assert [p.shape for p in outs["preds_c"]] == (
        [(1, K, h, w)] * (3 if method == "propnet" else 1))
    _, loss_fn = build_method(method, _cfgs()[1], args)
    labels = torch.from_numpy(np.random.default_rng(6).integers(
        0, K, (4, 1, H, W)))
    loss, _ = loss_fn(outs, {"labels": labels})
    loss.backward()
    assert torch.isfinite(loss)
    head = {"propnet": "segblock.conv1.conv1.weight",
            "our_warp_merge": "prop_clip.last_layer2.1.weight"}[method]
    grads = dict(port.named_parameters())
    assert grads[head].grad.abs().max() > 0
    assert grads["encoder.conv1.weight"].grad.abs().max() > 0
    with pytest.raises(ValueError):
        port(torch.zeros(4, 1, 3, *PAD), valid_hw=(H, W))

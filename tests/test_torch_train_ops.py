"""The training pieces of the port against their JAX counterparts, on the
same numpy inputs: BatchNorm in training mode, dropout, the loss functions
and their input gradients, ``pixel_acc``, the gradients of ``flowwarp`` and
``resize_bilinear``, the clip-recipe SGD against the optax chain, and the
train datasets and loader.  Float tolerances are atol 1e-5 unless stated
(f32 on both sides, sums in another order); data arrays must be identical.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from cvpr2021_vspw_implement_tpu.data import datasets as jdata
from cvpr2021_vspw_implement_tpu.data import loader as jloader
from cvpr2021_vspw_implement_tpu.models import layers as jlayers
from cvpr2021_vspw_implement_tpu.models import segmentation as jseg
from cvpr2021_vspw_implement_tpu.ops import interpolate as jinterp
from cvpr2021_vspw_implement_tpu.ops.warp import flowwarp as jax_flowwarp
from cvpr2021_vspw_implement_tpu.parallel.optim import (
    create_clip_optimizer as jax_clip_optimizer)
from cvpr2021_vspw_implement_tpu.parallel.optim import \
    poly_schedule as jax_poly
from cvpr2021_vspw_implement_tpu.utils.metrics import pixel_acc as jax_acc
from cvpr2021_vspw_implement_tpu_torch import data as pdata
from cvpr2021_vspw_implement_tpu_torch.models import layers, segmentation
from cvpr2021_vspw_implement_tpu_torch.ops import interpolate
from cvpr2021_vspw_implement_tpu_torch.ops.warp import flowwarp
from cvpr2021_vspw_implement_tpu_torch.parallel import (create_clip_optimizer,
                                                        poly_schedule,
                                                        to_device)
from cvpr2021_vspw_implement_tpu_torch.utils import AverageMeter, pixel_acc
from torch_port_util import to_nchw, to_nhwc


def test_batchnorm_training_matches_jax():
    """Outputs of two training steps, the running statistics after them,
    and the eval output that uses those."""
    rng = np.random.default_rng(0)
    xs = [rng.normal(1.5, 2.0, size=(3, 5, 7, 4)).astype(np.float32)
          for _ in range(3)]
    jbn = jlayers.BatchNorm2d(4)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    variables = {"params": {"scale": jnp.asarray([0.5, 1.0, 1.5, 2.0]),
                            "bias": jnp.asarray([0.1, -0.1, 0.0, 0.3])},
                 "batch_stats": variables["batch_stats"]}
    bn = layers.BatchNorm2d(4)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([0.5, 1.0, 1.5, 2.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.1, 0.0, 0.3]))
    bn.train()
    for x in xs[:2]:
        want, mutated = jbn.apply(variables, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
        variables = {"params": variables["params"], **mutated}
        np.testing.assert_allclose(to_nhwc(bn(to_nchw(x))), np.asarray(want),
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               variables["batch_stats"]["mean"], atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               variables["batch_stats"]["var"], atol=1e-5)
    bn.eval()
    want = jbn.apply(variables, jnp.asarray(xs[2]), train=False)
    np.testing.assert_allclose(to_nhwc(bn(to_nchw(xs[2]))), np.asarray(want),
                               atol=1e-5, rtol=0)


def test_dropout_override_and_generator():
    drop = layers.Dropout2d(0.5).train()
    x = torch.ones(4, 64, 3, 5)
    try:
        layers.set_dropout_generator(drop, torch.Generator().manual_seed(1))
        a = drop(x)
        layers.set_dropout_generator(drop, torch.Generator().manual_seed(1))
        b = drop(x)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        # whole channels are dropped; the kept ones are scaled by 1/(1-p)
        per_channel = a.flatten(2)
        assert (per_channel.min(2).values == per_channel.max(2).values).all()
        assert set(a.unique().tolist()) == {0.0, 2.0}
        layers.set_dropout_override(0.0)    # the JAX hook's semantics
        assert drop(x) is x
        layers.set_dropout_override(None)
        assert not torch.equal(drop(x), x)
        assert drop.eval()(x) is x
    finally:
        layers.set_dropout_override(None)


def _loss_inputs(seed, b=2, k=7, fhw=(6, 9), hw=(41, 67)):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, size=(b, *fhw, k)).astype(np.float32)
    label = rng.integers(0, k, size=(b, *hw)).astype(np.int32)
    label[rng.random(label.shape) < 0.2] = 255
    return logits, label


@pytest.mark.parametrize("name", ["upsampled_logprob_loss",
                                  "upsampled_logprob_loss_projected"])
def test_upsampled_losses_match_jax(name):
    """Value and gradient w.r.t. the logits; the projected form equals the
    direct one on both sides."""
    logits, label = _loss_inputs(1)
    want, want_grad = jax.value_and_grad(getattr(jseg, name))(
        jnp.asarray(logits), jnp.asarray(label))
    t = to_nchw(logits).requires_grad_(True)
    lab = torch.from_numpy(label).long()
    got = getattr(segmentation, name)(t, lab)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(to_nhwc(t.grad), np.asarray(want_grad),
                               atol=1e-6, rtol=1e-4)
    direct = segmentation.upsampled_logprob_loss(t.detach(), lab)
    projected = segmentation.upsampled_logprob_loss_projected(t.detach(), lab)
    np.testing.assert_allclose(projected.item(), direct.item(), rtol=1e-5)


def test_nll_from_logprobs_matches_jax():
    logits, _ = _loss_inputs(2, fhw=(11, 13))
    label = np.random.default_rng(3).integers(0, 7, size=(2, 11, 13)).astype(
        np.int32)
    label[0, :3] = 255
    logp = jax.nn.log_softmax(jnp.asarray(logits), -1)
    want, want_grad = jax.value_and_grad(jseg.nll_from_logprobs)(
        logp, jnp.asarray(label))
    t = to_nchw(np.asarray(logp)).requires_grad_(True)
    got = segmentation.nll_from_logprobs(t, torch.from_numpy(label).long())
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(to_nhwc(t.grad), np.asarray(want_grad),
                               atol=1e-7)
    # all pixels ignored: zero, not nan
    none = segmentation.nll_from_logprobs(
        t.detach(), torch.full((2, 11, 13), 255))
    assert none.item() == 0.0
    np.testing.assert_allclose(
        to_nhwc(layers.log_softmax(to_nchw(logits))), np.asarray(logp),
        atol=1e-6)


def test_pixel_acc_and_average_meter_match_jax():
    logits, _ = _loss_inputs(4, fhw=(11, 13))
    label = np.random.default_rng(5).integers(-1, 7, size=(2, 11, 13))
    want = float(jax_acc(jnp.asarray(logits), jnp.asarray(label)))
    got = pixel_acc(to_nchw(logits), torch.from_numpy(label))
    assert abs(got.item() - want) < 1e-7
    meter = AverageMeter()
    assert meter.average() is None
    meter.update(2.0)
    meter.update(4.0, 3)
    assert meter.value() == 4.0 and meter.average() == 3.5


def test_flowwarp_gradient_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, 12, 3)).astype(np.float32)
    flow = rng.normal(0, 2.5, size=(2, 9, 12, 2)).astype(np.float32)
    wgt = rng.normal(size=x.shape).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(
        jax_flowwarp(a, jnp.asarray(flow)) * wgt))(jnp.asarray(x))
    t = to_nchw(x).requires_grad_(True)
    (flowwarp(t, to_nchw(flow)) * to_nchw(wgt)).sum().backward()
    np.testing.assert_allclose(to_nhwc(t.grad), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("size", [(23, 31), (4, 5)])
def test_resize_bilinear_gradient_matches_jax(size):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 7, 11, 3)).astype(np.float32)
    wgt = rng.normal(size=(2, *size, 3)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(
        jinterp.resize_bilinear(a, size) * wgt))(jnp.asarray(x))
    t = to_nchw(x).requires_grad_(True)
    (interpolate.resize_bilinear(t, size) * to_nchw(wgt)).sum().backward()
    np.testing.assert_allclose(to_nhwc(t.grad), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(interpolate.linear_weights(7, size[0]),
                                  jinterp._linear_weights(7, size[0], False))


class _Tiny(nn.Module):
    """Parameters under ``encoder``, a head and a frozen ``raft``."""

    def __init__(self):
        super().__init__()
        self.encoder = nn.Sequential(nn.Conv2d(2, 3, 1), nn.BatchNorm2d(3))
        self.head = nn.Conv2d(3, 2, 1)
        self.raft = nn.Conv2d(1, 1, 1)


_FLAX_NAMES = {"encoder.0.weight": ("encoder", "conv", "kernel"),
               "encoder.0.bias": ("encoder", "conv", "bias"),
               "encoder.1.weight": ("encoder", "bn", "scale"),
               "encoder.1.bias": ("encoder", "bn", "bias"),
               "head.weight": ("head", "kernel"),
               "head.bias": ("head", "bias"),
               "raft.weight": ("raft", "conv", "kernel"),
               "raft.bias": ("raft", "conv", "bias")}


def _tree(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return tree


@pytest.mark.parametrize("fix", [False, True])
def test_clip_sgd_recipe_matches_optax(fix):
    """Three steps on the same gradients: groups (0.1x encoder), the decay
    mask (everything but biases), the poly LR from count 0, ``--fix`` and
    the frozen RAFT.  rtol 1e-6: the same f32 arithmetic."""
    rng = np.random.default_rng(8)
    model = _Tiny()
    names = dict(model.named_parameters())
    init = {n: rng.normal(size=tuple(p.shape)).astype(np.float32)
            for n, p in names.items()}
    with torch.no_grad():
        for n, p in names.items():
            p.copy_(torch.from_numpy(init[n]))
    params = _tree({_FLAX_NAMES[n]: jnp.asarray(v) for n, v in init.items()})
    tx = jax_clip_optimizer(params, lr=0.05, max_iters=5, momentum=0.9,
                            weight_decay=0.01, lr_pow=0.9, fix_encoder=fix)
    opt_state = tx.init(params)
    optimizer, scheduler = create_clip_optimizer(
        model, lr=0.05, max_iters=5, momentum=0.9, weight_decay=0.01,
        lr_pow=0.9, fix_encoder=fix)
    in_optimizer = {id(p) for g in optimizer.param_groups for p in g["params"]}
    assert id(model.raft.weight) not in in_optimizer
    assert (id(model.encoder[0].weight) in in_optimizer) == (not fix)
    for step in range(3):
        grads = {n: rng.normal(size=v.shape).astype(np.float32)
                 for n, v in init.items()}
        updates, opt_state = tx.update(
            _tree({_FLAX_NAMES[n]: jnp.asarray(g) for n, g in grads.items()}),
            opt_state, params)
        params = optax.apply_updates(params, updates)
        for n, p in names.items():
            p.grad = torch.from_numpy(grads[n])
        optimizer.step()
        scheduler.step()
        for n, p in names.items():
            want = params
            for key in _FLAX_NAMES[n]:
                want = want[key]
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{n} at step {step}")
        if fix:
            np.testing.assert_array_equal(
                model.encoder[0].weight.detach().numpy(),
                init["encoder.0.weight"])
        np.testing.assert_array_equal(model.raft.weight.detach().numpy(),
                                      init["raft.weight"])
    for count in (0, 1, 4, 5, 7):
        assert poly_schedule(0.02, 5)(count) == pytest.approx(
            float(jax_poly(0.02, 5)(count)), rel=1e-6, abs=1e-12)


@pytest.fixture(scope="module")
def vspw_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vspw_train_ops")
    pdata.make_synthetic_vspw(str(root), num_videos=5, frames_per_video=13,
                              size=(40, 56), num_class=5, seed=11)
    return str(root)


def _data_args(root, **kw):
    ns = argparse.Namespace(dataroot=root, cropsize=48, clip_num=3,
                            dilation_num=1, dilation2="1,3", lesslabel=False,
                            multi_scale=True)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


@pytest.mark.parametrize("cls", ["ClipDataset", "LongClipDataset"])
@pytest.mark.parametrize("multi_scale", [True, False])
def test_train_datasets_identical(vspw_root, cls, multi_scale):
    """One seed gives both packages the same clips: sampling, flip, scale,
    pad and crop draws, the decode and the normalization."""
    args = _data_args(vspw_root, multi_scale=multi_scale)
    mine = getattr(pdata, cls)(args, "train", seed=3)
    ref = getattr(jdata, cls)(args, "train", seed=3)
    assert len(mine) == len(ref) == 5
    for idx in (0, 3, 1, 3, 4, 2):
        (imgs, labs), (rimgs, rlabs) = mine[idx], ref[idx]
        assert len(imgs) == len(rimgs) == 3
        for a, b in zip(imgs + labs, rimgs + rlabs):
            assert a.shape[:2] == (48, 48)
            np.testing.assert_array_equal(a, b)


def test_loader_and_collate_identical(vspw_root):
    args = _data_args(vspw_root, clip_num=4, dilation2="1,2,3")
    collate = pdata.make_collate_target_last(0)
    mine = pdata.PrefetchLoader(pdata.LongClipDataset(args, "train", seed=5),
                                2, collate, seed=5)
    ref = jloader.PrefetchLoader(jdata.LongClipDataset(args, "train", seed=5),
                                 2, jloader.make_collate_target_last(0),
                                 seed=5)
    assert len(mine) == len(ref) == 2
    for _ in range(2):                      # two epochs: the order reshuffles
        got, want = list(mine), list(ref)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g["img"].shape == (4, 2, 48, 48, 3)
            np.testing.assert_array_equal(g["img"], w["img"])
            np.testing.assert_array_equal(g["labels"], w["labels"])
    # the middle frame of a contiguous clip goes last
    items = [([np.full((2, 2, 3), k, np.float32) for k in range(2)],
              [np.full((2, 2), k, np.int32) for k in range(2)])]
    batch = pdata.make_collate_target_last(1)(items)
    want = jloader.make_collate_target_last(1)(items)
    np.testing.assert_array_equal(batch["labels"], want["labels"])
    dev = to_device(batch, "cpu")
    assert dev["img"].shape == (2, 1, 3, 2, 2)
    assert dev["labels"].dtype == torch.int64
    assert dev["labels"][-1].unique().tolist() == [1]

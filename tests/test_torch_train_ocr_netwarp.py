"""The clip trainer's step for ``clip_ocr``, ``netwarp``, ``netwarp_ocr`` and
``etc_ocr`` against the JAX trainer, and the weight carry-over of their
models.

One shared init (Flax variables carried over by ``convert.py``), the same
numpy batches, dropout off on both sides (its draws cannot be matched):
the loss curves (3 steps) must track the JAX trainer (``make_train_step``
+ ``create_clip_optimizer``) within rtol 1e-2, the JAX package's own
curve-parity bar, and the accuracies within 1e-2.  ResNet-18-dilated,
fc_dim 512, 5 classes; RAFT at 2 refinements with its flow head scaled by
0.1, frozen on both sides: the port's RAFT must come out of the steps
unchanged, in eval mode and without gradients.  NetWarp's blend weights
start at seeded values in [0.3, 0.7] (``chip_smoke.live_netwarp_blend``;
at init they are 1 and 0, and the warped features would not reach the
loss).  The agreement found is printed (run with ``-s``).

Each model also round-trips: a seeded port init's ``state_dict()`` → the
JAX ``FUSED_IMPORTERS`` entry → ``load_jax_variables`` into a fresh port
model gives every tensor back equal (and the importer the same tree
again).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cvpr2021_vspw_implement_tpu.config import cfg as jax_default_cfg
from cvpr2021_vspw_implement_tpu.methods import build_method as jax_build
from cvpr2021_vspw_implement_tpu.models import layers as jlayers
from cvpr2021_vspw_implement_tpu.models.import_torch import FUSED_IMPORTERS
from cvpr2021_vspw_implement_tpu.parallel import TrainState, make_train_step
from cvpr2021_vspw_implement_tpu.parallel.optim import \
    create_clip_optimizer as jax_clip_optimizer
from cvpr2021_vspw_implement_tpu_torch import methods
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.models import layers
from cvpr2021_vspw_implement_tpu_torch.parallel import (create_clip_optimizer,
                                                        to_device, train_step)
from torch_port_util import assert_trees_equal, numpy_tree

K = 5
LR, MOM, WD, MAX_ITERS = 0.02, 0.9, 1e-4, 20
#: method → (frames, batch, crop): clip_ocr's 4-frame long clip, the
#: others a pair; 71 pads to 72 for RAFT (9x9 features, levels 9, 4, 2, 1).
#: clip_ocr and netwarp_ocr at batch 4: their region features batch-
#: normalise B x K values a channel, and at B = 2 the backward amplifies f32
#: rounding to 4e-3 of the loss by the third step (5e-4 at B = 4)
SHAPES = {"clip_ocr": (4, 4, 48), "netwarp": (2, 2, 71),
          "netwarp_ocr": (2, 4, 71), "etc_ocr": (2, 2, 71)}


@pytest.fixture()
def no_dropout():
    jlayers.set_dropout_override(0.0)
    layers.set_dropout_override(0.0)
    yield
    jlayers.set_dropout_override(None)
    layers.set_dropout_override(None)


def _args(method):
    return argparse.Namespace(
        num_class=K, method=method, clip_num=SHAPES[method][0],
        dilation_num=0, dilation2="3,6,9", deepsup_scale=0.4, st_weight=0.1,
        allsup=False, allsup_scale=0.3, linear_combine=False,
        distsoftmax=False, distnearest=False, temp=3.0, max_distances=[2],
        fix=False, psp_weight=False, use_memory=False, memory_num=8,
        clipocr_all=False)


def _models(method):
    """(JAX model, JAX loss, variables, port model, port loss): the port's
    seeded init in JAX through its importer, and back in a second port
    model through ``load_jax_variables``."""
    cfg = jax_default_cfg.clone()
    cfg.MODEL.arch_encoder = "resnet18dilated"
    cfg.MODEL.fc_dim = 512
    cfg.TPU.compute_dtype = "float32"
    cfg.TPU.raft_iters = 2
    pcfg = port_default_cfg.clone()
    pcfg.MODEL.arch_encoder = "resnet18dilated"
    pcfg.MODEL.fc_dim = 512
    pcfg.TPU.raft_iters = 2
    args = _args(method)
    jmodel, jloss = jax_build(method, cfg, args)
    seeded, loss = methods.build_method(method, pcfg, args)
    layers.init_weights(seeded, torch.Generator().manual_seed(3))
    with torch.no_grad():
        # the classifiers start small (logits of a few units, as the JAX
        # init gives): from kaiming's fan-out scale the loss climbs to 40
        # in three steps and the curves part on f32 rounding alone
        for m in seeded.modules():
            if isinstance(m, torch.nn.Conv2d) and m.out_channels == K:
                m.weight.mul_(0.1)
        if hasattr(seeded, "raft"):
            seeded.raft.update_block.flow_head.conv2.weight.mul_(0.1)
            seeded.raft.update_block.flow_head.conv2.bias.mul_(0.1)
    if method.startswith("netwarp"):
        chip_smoke.live_netwarp_blend(torch, seeded, seed=5)
    variables = numpy_tree(FUSED_IMPORTERS[method](seeded.state_dict()))
    model = load_jax_variables(methods.build_method(method, pcfg, args)[0],
                               variables)
    return jmodel, jloss, variables, model, loss, seeded


def _batches(rng, steps, t, b, crop):
    out = []
    for _ in range(steps):
        img = rng.standard_normal((t, b, crop, crop, 3)).astype(np.float32)
        lab = rng.integers(0, K, (t, b, crop, crop)).astype(np.int32)
        lab[:, :, 0, :3] = 255                      # exercise ignore_index
        out.append({"img": img, "labels": lab})
    return out


def _jax_curve(jmodel, variables, loss_fn, batches):
    tx = jax_clip_optimizer(variables["params"], lr=LR, max_iters=MAX_ITERS,
                            momentum=MOM, weight_decay=WD)
    state = TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    step = make_train_step(jmodel, tx, loss_fn=loss_fn, donate=False)
    key = jax.random.PRNGKey(0)
    curve = []
    for batch in batches:
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, key)
        curve.append((float(metrics["loss"]), float(metrics["acc"])))
    return np.array(curve), state


def _port_curve(model, loss_fn, batches):
    optimizer, scheduler = create_clip_optimizer(
        model, lr=LR, max_iters=MAX_ITERS, momentum=MOM, weight_decay=WD)
    curve = []
    for batch in batches:
        metrics = train_step(model, optimizer, scheduler,
                             to_device(batch, "cpu"), loss_fn)
        curve.append((metrics["loss"].item(), metrics["acc"].item()))
    return np.array(curve)


@pytest.mark.parametrize("method", list(SHAPES))
def test_curve_matches_jax(no_dropout, method):
    jmodel, jloss, variables, model, loss, seeded = _models(method)
    # the round trip: port → JAX importer → load_jax_variables → port
    want_sd = seeded.state_dict()
    got_sd = model.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
    back = FUSED_IMPORTERS[method](got_sd)
    assert_trees_equal(back["params"], variables["params"])
    assert_trees_equal(back["batch_stats"], variables["batch_stats"])

    raft = getattr(model, "raft", None)
    raft_before = ({} if raft is None else
                   {k: v.clone() for k, v in raft.state_dict().items()})
    t, b, crop = SHAPES[method]
    batches = _batches(np.random.default_rng(4), 3, t, b, crop)
    want, state = _jax_curve(jmodel, variables, jloss, batches)
    got = _port_curve(model, loss, batches)
    rel = np.abs(got[:, 0] - want[:, 0]) / np.abs(want[:, 0])
    print(f"\n{method}: port losses {got[:, 0]}, JAX losses {want[:, 0]}, "
          f"max relative difference {rel.max():.2e}")
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-2)
    np.testing.assert_allclose(got[:, 1], want[:, 1], atol=1e-2)
    # the steps did move the loss: a curve, not one number three times
    assert np.ptp(want[:, 0]) > 1e-3 * abs(want[0, 0])

    assert model.training
    if raft is not None:
        assert not raft.training
        assert all(not p.requires_grad and p.grad is None
                   for p in raft.parameters())
        for k, v in raft.state_dict().items():
            assert torch.equal(v, raft_before[k]), k
        # the JAX trainer leaves its RAFT where it was, too
        np.testing.assert_array_equal(
            np.asarray(state.params["raft"]["fnet"]["conv1"]["conv"][
                "kernel"]),
            variables["params"]["raft"]["fnet"]["conv1"]["conv"]["kernel"])


def test_only_tdnet_and_nonlocal3d_are_unported():
    """Since tdnet and nonlocal3d are ported too, every method of the JAX
    clip trainer builds in the port: none is left unported."""
    from cvpr2021_vspw_implement_tpu_torch.config.args import \
        TEMPORAL_METHODS
    cfg = port_default_cfg.clone()
    cfg.MODEL.arch_encoder = "resnet18dilated"
    cfg.MODEL.fc_dim = 512
    unported = []
    for method in TEMPORAL_METHODS:
        args = _args(method) if method in SHAPES else argparse.Namespace(
            **{**vars(_args("netwarp")), "method": method,
               "clip_num": 4 if method in ("clip_psp", "our_warp", "propnet",
                                           "our_warp_merge") else 2})
        try:
            methods.build_method(method, cfg, args)
        except NotImplementedError:
            unported.append(method)
    assert unported == []

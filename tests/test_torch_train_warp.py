"""Training of the window methods (our_warp, our_warp_merge, propnet) in the
port against the JAX trainer, and through the port's CLI, on the CPU.

* Loss curves, 4 steps at ResNet-18-dilated, fc_dim 512, 5 classes, 4
  frames of 48x48, batch 4, r = 2, LR 0.005: a seeded port init carried to
  JAX through ``import_clip_warp_state_dict``,
  ``import_warp_merge_state_dict`` and ``import_propnet_state_dict``, the
  same numpy batches, dropout off on both sides; the JAX side is
  ``make_train_step`` with its losses (``clip_warp_loss``,
  ``warp_merge_loss``, ``propnet_loss``) and ``create_clip_optimizer``.  The
  bar is the clip trainer's (tests/test_torch_train_clip.py::_report): rtol
  1e-2 on the loss, atol 1e-2 on the accuracy.  B5's gradients on the
  port's side come from its explicit plain backward (ops/local_agg.py), on
  JAX's from ``jax.grad`` of its XLA formulation.  Cases: our_warp sigmoid
  with ``allsup``, softmax, nearest, sigmoid with ``allsup`` and ``fix``
  (the encoder frozen on both sides), our_warp_merge and propnet.

  Why batch 4 and LR 0.005, and why PropNet holds two steps here.  The
  trunk and the decoder train through BatchNorm over a 6x6 grid, where the
  JAX package's float32 statistics (one-pass E[x^2] - E[x]^2) cancel, and
  training carries each step's rounding forward; the batch and the rate
  were chosen so that the float32 curves stay within the bar over four
  steps (with ``fix`` the trunk is frozen).  PropNet propagates hard
  labels, an argmax of its per-frame head, and once a label flips a
  float32 curve leaves the exact one: both the port's and JAX's float32
  curves part from their float64 curves by more than the bar at the third
  or fourth step (printed by tests/test_torch_train_propnet_f64.py, which
  holds the port's float64 curve against the JAX trainer's float64 curve
  over all four steps).  Here its first two steps are held at the bar; the
  last two are printed.
* PropNet's class-masked window minimum splits the gradient evenly among
  tied minima, as JAX's ``min`` does: ``prop_pred``'s gradient against
  ``jax.grad`` of JAX's on embeddings with planted ties.
* ``train_clip --method {our_warp, our_warp_merge, propnet} --device cpu``
  trains on the synthetic fixture and saves a checkpoint.
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2021_vspw_implement_tpu.config import cfg as jax_default_cfg
from cvpr2021_vspw_implement_tpu.methods import build_method as jax_build
from cvpr2021_vspw_implement_tpu.models import layers as jlayers
from cvpr2021_vspw_implement_tpu.models import propnet as jax_propnet
from cvpr2021_vspw_implement_tpu.models.import_torch import (
    import_clip_warp_state_dict, import_propnet_state_dict,
    import_warp_merge_state_dict)
from cvpr2021_vspw_implement_tpu.parallel import TrainState, make_train_step
from cvpr2021_vspw_implement_tpu.parallel.optim import \
    create_clip_optimizer as jax_clip_optimizer
from cvpr2021_vspw_implement_tpu_torch import train_clip
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.data import make_synthetic_vspw
from cvpr2021_vspw_implement_tpu_torch.methods import build_method
from cvpr2021_vspw_implement_tpu_torch.models import layers, propnet
from cvpr2021_vspw_implement_tpu_torch.parallel import (create_clip_optimizer,
                                                        to_device, train_step)
from torch_port_util import to_nchw, to_nhwc

K, T, B, S = 5, 4, 4, 48
LR, MOM, WD, MAX_ITERS, STEPS = 0.005, 0.9, 1e-4, 20, 4
PRESET = os.path.join(os.path.dirname(train_clip.__file__), "config",
                      "presets", "vsp-resnet18dilated-ppm_deepsup_clip.yaml")
IMPORTERS = {"our_warp": import_clip_warp_state_dict,
             "our_warp_merge": import_warp_merge_state_dict,
             "propnet": import_propnet_state_dict}
CASES = {
    "our_warp": ("our_warp", {"allsup": True}),
    "our_warp_softmax": ("our_warp", {"distsoftmax": True}),
    "our_warp_nearest": ("our_warp", {"distnearest": True}),
    "our_warp_fix": ("our_warp", {"allsup": True, "fix": True}),
    "our_warp_merge": ("our_warp_merge", {}),
    "propnet": ("propnet", {}),
}


@pytest.fixture()
def no_dropout():
    jlayers.set_dropout_override(0.0)
    layers.set_dropout_override(0.0)
    yield
    jlayers.set_dropout_override(None)
    layers.set_dropout_override(None)


def _args(**kw):
    ns = argparse.Namespace(
        num_class=K, method="our_warp", clip_num=T, dilation_num=0,
        dilation2="3,6,9", deepsup_scale=0.4, st_weight=0.1, allsup=False,
        allsup_scale=0.3, linear_combine=False, distsoftmax=False,
        distnearest=False, temp=3.0, max_distances=[2], fix=False,
        psp_weight=False, use_memory=False, memory_num=8,
        clipocr_all=False)
    for key, v in kw.items():
        setattr(ns, key, v)
    return ns


def _cfgs():
    cfg = jax_default_cfg.clone()
    cfg.MODEL.arch_encoder = "resnet18dilated"
    cfg.MODEL.fc_dim = 512
    cfg.TPU.compute_dtype = "float32"
    pcfg = port_default_cfg.clone()
    pcfg.merge_from_file(PRESET)
    return cfg, pcfg


def _batches(rng):
    out = []
    for _ in range(STEPS):
        img = rng.standard_normal((T, B, S, S, 3)).astype(np.float32)
        lab = rng.integers(0, K, (T, B, S, S)).astype(np.int32)
        lab[:, :, 0, :3] = 255                      # exercise ignore_index
        out.append({"img": img, "labels": lab})
    return out


def _jax_curve(jmodel, variables, loss_fn, batches, fix):
    tx = jax_clip_optimizer(variables["params"], lr=LR, max_iters=MAX_ITERS,
                            momentum=MOM, weight_decay=WD, fix_encoder=fix)
    state = TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    step = make_train_step(jmodel, tx, loss_fn=loss_fn, donate=False)
    curve = []
    with jax.default_matmul_precision("highest"):
        for batch in batches:
            state, metrics = step(state, {k: jnp.asarray(v)
                                          for k, v in batch.items()},
                                  jax.random.PRNGKey(0))
            curve.append((float(metrics["loss"]), float(metrics["acc"])))
    return np.array(curve), state


def _port_curve(model, loss_fn, batches, fix):
    optimizer, scheduler = create_clip_optimizer(
        model, lr=LR, max_iters=MAX_ITERS, momentum=MOM, weight_decay=WD,
        fix_encoder=fix)
    curve = []
    for batch in batches:
        metrics = train_step(model, optimizer, scheduler,
                             to_device(batch, "cpu"), loss_fn)
        curve.append((metrics["loss"].item(), metrics["acc"].item()))
    return np.array(curve)


def _report(name, got, want, held=STEPS):
    """The clip trainer's bar on the first ``held`` steps."""
    rel = np.abs(got[:, 0] - want[:, 0]) / np.abs(want[:, 0])
    print(f"\n{name}: port losses {got[:, 0]}, JAX losses {want[:, 0]}, "
          f"relative differences {rel}, held over {held} steps")
    np.testing.assert_allclose(got[:held, 0], want[:held, 0], rtol=1e-2)
    np.testing.assert_allclose(got[:held, 1], want[:held, 1], atol=1e-2)
    # the steps did move the loss: a curve, not one number four times
    assert np.ptp(want[:, 0]) > 1e-3 * abs(want[0, 0])


@pytest.mark.parametrize("case", list(CASES))
def test_curve_matches_jax(no_dropout, case):
    method, opts = CASES[case]
    fix = opts.get("fix", False)
    cfg, pcfg = _cfgs()
    args = _args(method=method, **opts)
    jmodel, jax_loss = jax_build(method, cfg, args)
    port, port_loss = build_method(method, pcfg, args)
    layers.init_weights(port, torch.Generator().manual_seed(1))
    variables = IMPORTERS[method](port.state_dict())
    # a copy: the importer's arrays may share the port's memory
    variables = jax.tree_util.tree_map(np.array, variables)
    encoder = {k: v.clone() for k, v in port.encoder.state_dict().items()}

    batches = _batches(np.random.default_rng(2))
    want, state = _jax_curve(jmodel, variables, jax_loss, batches, fix)
    got = _port_curve(port.train(), port_loss, batches, fix)
    _report(case, got, want, held=2 if method == "propnet" else STEPS)
    assert port.training
    moved = [k for k, v in port.encoder.state_dict().items()
             if not torch.equal(v, encoder[k])]
    jax_kernel = np.asarray(
        state.params["encoder"]["conv1"]["conv"]["kernel"])
    start = variables["params"]["encoder"]["conv1"]["conv"]["kernel"]
    if fix:
        # the encoder frozen: no update, no BatchNorm statistics
        assert not moved
        np.testing.assert_array_equal(jax_kernel, start)
        assert port.encoder.training is False
    else:
        assert "conv1.weight" in moved and "bn1.running_mean" in moved
        assert not np.array_equal(jax_kernel, start)


def _prop_tie_inputs(seed, b=2, h=9, w=12, c=8):
    """Embeddings whose columns come in identical pairs (2i, 2i + 1), and
    labels constant on each pair: a class's window minimum is then often
    attained at two positions at once, bit for bit on both sides."""
    rng = np.random.default_rng(seed)
    prev = rng.standard_normal((b, h, w // 2, c)).astype(np.float32) * 0.3
    prev = np.repeat(prev, 2, axis=2)
    query = (prev + 0.1 * rng.standard_normal(prev.shape)).astype(
        np.float32)
    labels = np.repeat(rng.integers(0, K, (b, h, w // 2)), 2, axis=2)
    up = rng.standard_normal((b, h, w, K)).astype(np.float32)
    return prev, query, labels.astype(np.int32), up


def test_prop_pred_gradient_splits_ties_as_jax():
    r = 2
    prev, query, labels, up = _prop_tie_inputs(5)

    def jax_loss(p, q):
        return jnp.sum(jax_propnet.prop_pred(p, q, labels, r, K) * up)
    jp, jq = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(prev),
                                                jnp.asarray(query))
    p_t, q_t = to_nchw(prev).requires_grad_(), to_nchw(query).requires_grad_()
    out = propnet.prop_pred(p_t, q_t, torch.from_numpy(labels), r, K)
    (out * to_nchw(up)).sum().backward()

    # ties were planted: some minima sit at two window positions
    d = np.asarray(jax.nn.sigmoid(jax_propnet.local_pairwise_dist(
        jnp.asarray(query), jnp.asarray(prev), r)) - 0.5) * 2.0
    k = 2 * r + 1
    lwin = np.asarray(jax_propnet.local_window_gather(
        jnp.asarray(labels[..., None].astype(np.float32)), r, -1.0)).reshape(
            *labels.shape, k * k)
    d = d.reshape(*labels.shape, k * k)
    ties = 0
    for c in range(K):
        masked = np.where(lwin == c, d, 1.0)
        m = masked.min(-1, keepdims=True)
        ties += int((((masked == m) & (lwin == c)).sum(-1) > 1)[
            m[..., 0] < 1].sum())
    assert ties > 50, ties

    for got, want in ((p_t.grad, jp), (q_t.grad, jq)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 1e-2
        assert np.abs(to_nhwc(got) - want).max() <= 1e-5 * scale


@pytest.fixture(scope="module")
def vspw_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vspw_train_warp")
    make_synthetic_vspw(str(root), num_videos=4, frames_per_video=12,
                        size=(48, 64), num_class=K, seed=7)
    return str(root)


@pytest.mark.parametrize("method,extra", [
    ("our_warp", ["--allsup", "true"]),
    ("our_warp", ["--distnearest", "true", "--fix", "true"]),
    ("our_warp_merge", []), ("propnet", [])])
def test_train_clip_cli_trains_window_methods(vspw_root, tmp_path, method,
                                              extra):
    """Two steps (one epoch of 4 videos at batch 2), a checkpoint whose
    heads moved; the encoder too, unless ``--fix``."""
    model = train_clip.main([
        "--cfg", PRESET, "--dataroot", vspw_root, "--num_class", str(K),
        "--method", method, "--clip_num", "4", "--max_distances", "2",
        "--batchsize", "2", "--cropsize", "48", "--lr", "0.01",
        "--totalepoch", "1", "--device", "cpu", "--saveroot",
        str(tmp_path / "save"), *extra, "DIR", str(tmp_path / "ckpt"),
        "TRAIN.disp_iter", "1"])
    assert model.training
    saved = torch.load(tmp_path / "save" / "model_epoch_1.pth",
                       map_location="cpu")
    assert (saved["step"], saved["epoch"]) == (2, 1)
    init, _ = build_method(method, _cfgs()[1], _args(method=method))
    layers.init_weights(init, torch.Generator().manual_seed(
        _cfgs()[1].TRAIN.seed))
    start = init.state_dict()
    moved = {k for k, v in saved["model"].items()
             if v.is_floating_point() and not torch.equal(v, start[k])}
    head = {"our_warp": "prop_clip.emb_2.0.weight",
            "our_warp_merge": "prop_clip.emb2.0.weight",
            "propnet": "segblock.conv1.conv1.weight"}[method]
    assert head in moved
    assert ("encoder.conv1.weight" in moved) != ("--fix" in extra)
    assert all(torch.isfinite(v).all() for v in saved["model"].values()
               if v.is_floating_point())

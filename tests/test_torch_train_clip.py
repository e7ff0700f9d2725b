"""The clip trainer of the port against the JAX trainer, and its CLI.

One shared init (Flax variables carried over by ``convert.py``), the same
numpy batches, dropout off on both sides (its draws cannot be matched):
the loss curves of ``clip_psp`` (4 steps) and ``ETC`` (3 steps, RAFT with 2
refinements) must track the JAX trainer (``make_train_step`` +
``create_clip_optimizer``) within rtol 1e-2, the JAX package's own
curve-parity bar.  ResNet-18-dilated, fc_dim 512.  The agreement found is
printed (run with ``-s``); on the CPU it was 3e-4 relative at clip_psp's
fourth step and 2e-4 at ETC's third, growing from 1e-7 at the first: the
pyramid's 1x1 branch batch-normalises only B values per channel, so the
backward amplifies f32 rounding (at B = 2 the port's own f32 and f64
gradients differ by up to 12%, and the clip_psp curves drift to 7e-3 by the
fourth step, which is why that test runs B = 4).
"""

import argparse
import os
import shutil
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2021_vspw_implement_tpu.models import layers as jlayers
from cvpr2021_vspw_implement_tpu.models.builder import ModelBuilder
from cvpr2021_vspw_implement_tpu.models.clip_psp import ClipPSP as JaxClipPSP
from cvpr2021_vspw_implement_tpu.models.clip_psp import \
    clip_psp_loss as jax_clip_psp_loss
from cvpr2021_vspw_implement_tpu.models.etc import ETC as JaxETC
from cvpr2021_vspw_implement_tpu.models.etc import etc_loss as jax_etc_loss
from cvpr2021_vspw_implement_tpu.models.import_torch import (
    import_clip_psp_state_dict, import_etc_state_dict)
from cvpr2021_vspw_implement_tpu.parallel import TrainState, make_train_step
from cvpr2021_vspw_implement_tpu.parallel.optim import \
    create_clip_optimizer as jax_clip_optimizer
from cvpr2021_vspw_implement_tpu_torch import methods, test_clip, train_clip
from cvpr2021_vspw_implement_tpu_torch.config import cfg as default_cfg
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.data import (collate_clips_in_order,
                                                    make_synthetic_vspw)
from cvpr2021_vspw_implement_tpu_torch.models import layers
from cvpr2021_vspw_implement_tpu_torch.models.clip_psp import (ClipPSP,
                                                               clip_psp_loss)
from cvpr2021_vspw_implement_tpu_torch.models.etc import ETC, etc_loss
from cvpr2021_vspw_implement_tpu_torch.models.resnet import build_encoder
from cvpr2021_vspw_implement_tpu_torch.parallel import (create_clip_optimizer,
                                                        to_device, train_step)
from cvpr2021_vspw_implement_tpu_torch.utils import setup_logger
from torch_port_util import assert_trees_equal, numpy_tree

K = 5
LR, MOM, WD, MAX_ITERS = 0.02, 0.9, 1e-4, 20
PRESET = os.path.join(os.path.dirname(train_clip.__file__), "config",
                      "presets", "vsp-resnet18dilated-ppm_deepsup_clip.yaml")


@pytest.fixture()
def no_dropout():
    jlayers.set_dropout_override(0.0)
    layers.set_dropout_override(0.0)
    yield
    jlayers.set_dropout_override(None)
    layers.set_dropout_override(None)


def _batches(rng, steps, t, b, h, w):
    out = []
    for _ in range(steps):
        img = rng.standard_normal((t, b, h, w, 3)).astype(np.float32)
        lab = rng.integers(0, K, (t, b, h, w)).astype(np.int32)
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


def _report(name, got, want):
    rel = np.abs(got[:, 0] - want[:, 0]) / np.abs(want[:, 0])
    print(f"\n{name}: port losses {got[:, 0]}, JAX losses {want[:, 0]}, "
          f"max relative difference {rel.max():.2e}")
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-2)
    np.testing.assert_allclose(got[:, 1], want[:, 1], atol=1e-2)
    # the steps did move the loss: a curve, not one number four times
    assert np.ptp(want[:, 0]) > 1e-3 * abs(want[0, 0])


def test_clip_psp_curve_matches_jax(no_dropout):
    jmodel = JaxClipPSP(
        encoder=ModelBuilder.build_encoder("resnet18dilated", fc_dim=512),
        num_class=K, fc_dim=512)
    key = jax.random.PRNGKey(1)
    variables = numpy_tree(jmodel.init(
        {"params": key, "dropout": key},
        jnp.zeros((4, 1, 48, 48, 3), jnp.float32), train=True))
    model = load_jax_variables(
        ClipPSP(build_encoder("resnet18dilated"), K, fc_dim=512), variables)
    back = import_clip_psp_state_dict(model.state_dict())
    assert_trees_equal(back["params"], variables["params"])
    assert_trees_equal(back["batch_stats"], variables["batch_stats"])

    batches = _batches(np.random.default_rng(2), 4, 4, 4, 48, 48)
    want, _ = _jax_curve(jmodel, variables,
                         partial(jax_clip_psp_loss, deep_sup_scale=0.4),
                         batches)
    got = _port_curve(model, partial(clip_psp_loss, deep_sup_scale=0.4),
                      batches)
    _report("clip_psp", got, want)


def test_etc_curve_matches_jax_and_raft_stays_frozen(no_dropout):
    jmodel = JaxETC(
        encoder=ModelBuilder.build_encoder("resnet18dilated", fc_dim=512),
        num_class=K, fc_dim=512, raft_iters=2)
    key = jax.random.PRNGKey(3)
    # 71 pads to 72 for RAFT: 9x9 features, pyramid levels 9, 4, 2, 1
    variables = numpy_tree(jmodel.init(
        {"params": key, "dropout": key},
        jnp.zeros((2, 1, 71, 71, 3), jnp.float32), train=True))
    # a trained-like flow step (see tests/test_torch_raft.py)
    variables["params"]["raft"]["update_block"]["flow_head"]["conv2"]["conv"][
        "kernel"] *= 0.1
    model = load_jax_variables(
        ETC(build_encoder("resnet18dilated"), K, fc_dim=512, raft_iters=2),
        variables)
    back = import_etc_state_dict(model.state_dict())
    assert_trees_equal(back["params"], variables["params"])
    assert_trees_equal(back["batch_stats"], variables["batch_stats"])

    raft_before = {k: v.clone() for k, v in model.raft.state_dict().items()}
    batches = _batches(np.random.default_rng(4), 3, 2, 2, 71, 71)
    want, state = _jax_curve(
        jmodel, variables,
        partial(jax_etc_loss, deep_sup_scale=0.4, st_weight=0.1), batches)
    got = _port_curve(model, partial(etc_loss, deep_sup_scale=0.4,
                                     st_weight=0.1), batches)
    _report("ETC", got, want)

    assert model.training and not model.raft.training
    assert all(not p.requires_grad for p in model.raft.parameters())
    for k, v in model.raft.state_dict().items():
        assert torch.equal(v, raft_before[k]), k
    # the JAX trainer leaves its RAFT where it was, too
    np.testing.assert_array_equal(
        np.asarray(state.params["raft"]["fnet"]["conv1"]["conv"]["kernel"]),
        variables["params"]["raft"]["fnet"]["conv1"]["conv"]["kernel"])
    # a parameter the loss does not reach (the decoder's embedding conv)
    # still decays, as in the optax chain
    np.testing.assert_allclose(
        model.decoder.conv_last_[0].weight.detach().numpy().transpose(
            2, 3, 1, 0),
        np.asarray(state.params["decoder"]["conv_last_"]["0"]["conv"][
            "kernel"]), rtol=1e-5, atol=1e-7)


def test_etc_inference_is_single_frame():
    model = ETC(build_encoder("resnet18dilated"), K, fc_dim=512,
                raft_iters=1).eval()
    layers.init_weights(model, torch.Generator().manual_seed(0))
    imgs = torch.randn(2, 1, 3, 40, 48)
    with torch.inference_mode():
        (pred,) = model(imgs)
        (same,) = model(imgs[-1:])
    assert pred.shape == (1, K, 5, 6)
    torch.testing.assert_close(pred, same, rtol=0, atol=0)


@pytest.fixture(scope="module")
def vspw_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vspw_train_clip")
    make_synthetic_vspw(str(root), num_videos=4, frames_per_video=14,
                        size=(48, 64), num_class=K, seed=7)
    return str(root)


def _cli(root, tmp_path, method, *extra):
    by_method = {"clip_psp": ["--clip_num", "4", "--dilation2", "3,6,9"],
                 "ETC": ["--clip_num", "2", "--dilation_num", "0",
                         "--st_weight", "0.1"]}[method]
    return ["--cfg", PRESET, "--dataroot", root, "--num_class", str(K),
            "--method", method, "--batchsize", "2", "--cropsize", "64",
            "--lr", "0.01", "--saveroot", str(tmp_path / "save"),
            *by_method, *extra, "DIR", str(tmp_path / "ckpt"),
            "TRAIN.disp_iter", "1", "TPU.raft_iters", "2"]


@pytest.mark.parametrize("method", ["clip_psp", "ETC"])
def test_train_clip_cli_saves_and_resumes(vspw_root, tmp_path, monkeypatch,
                                          method):
    """Two steps (one epoch of 4 videos at batch 2) on the CPU, a
    checkpoint, and ``--resume_epoch 1`` continuing from ./resume."""
    monkeypatch.chdir(tmp_path)
    model = train_clip.main(_cli(vspw_root, tmp_path, method, "--device",
                                 "cpu", "--totalepoch", "1"))
    assert model.training
    saved = tmp_path / "save" / "model_epoch_1.pth"
    first = torch.load(saved, map_location="cpu")
    assert (first["step"], first["epoch"]) == (2, 1)
    assert set(first["model"]) == set(model.state_dict())
    assert (tmp_path / "ckpt" / "config.yaml").exists()
    if method == "clip_psp":            # test_clip reads it back
        cfg = default_cfg.clone()
        cfg.merge_from_file(PRESET)
        loaded = test_clip.build_model(cfg, argparse.Namespace(
            num_class=K, psp_weight=False, load=str(saved)), "cpu")
        assert not loaded.training
        torch.testing.assert_close(loaded.state_dict()["deepsup.4.bias"],
                                   first["model"]["deepsup.4.bias"])

    os.makedirs(tmp_path / "resume")
    shutil.copy(saved, tmp_path / "resume" / "model_epoch_1.pth")
    train_clip.main(_cli(vspw_root, tmp_path, method, "--device", "cpu",
                         "--totalepoch", "2", "--resume_epoch", "1"))
    second = torch.load(tmp_path / "save" / "model_epoch_2.pth",
                        map_location="cpu")
    assert (second["step"], second["epoch"]) == (4, 2)
    assert second["scheduler"]["last_epoch"] == 4
    moved = [k for k, v in second["model"].items()
             if v.is_floating_point() and not torch.equal(v, first["model"][k])]
    assert any(k.startswith("encoder.") for k in moved)
    assert not any(k.startswith("raft.") for k in moved)
    assert all(torch.isfinite(v).all() for v in second["model"].values()
               if v.is_floating_point())


def test_train_clip_defaults_to_cuda(vspw_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_clip.main(_cli(vspw_root, tmp_path, "clip_psp"))


def test_unported_methods_and_validation_hook(vspw_root, tmp_path, caplog):
    args = argparse.Namespace(num_class=K, clip_num=2, dilation_num=0,
                              deepsup_scale=0.4, st_weight=0.1)
    # tdnet and nonlocal3d are ported: they build, with their in-order
    # collate and their losses
    tdnet, tdnet_loss = methods.build_method("tdnet", default_cfg, args)
    assert type(tdnet).__name__ == "TD4PSP" and tdnet_loss.__name__ == \
        "td4_loss"
    nl3d, nl3d_loss = methods.build_method("nonlocal3d", default_cfg, args)
    assert type(nl3d).__name__ == "NonLocal3D" and nl3d_loss.__name__ == \
        "nonlocal3d_loss"
    for method in ("tdnet", "nonlocal3d"):
        assert methods.get_collate(method, 4) is collate_clips_in_order
    with pytest.raises(ValueError, match="unknown method"):
        methods.build_method("nope", default_cfg, args)
    with pytest.raises(ValueError, match="clip_num=2"):
        methods.build_method("ETC", default_cfg, argparse.Namespace(
            **{**vars(args), "clip_num": 3}))
    assert methods.get_collate("clip_psp", 4).__closure__[0].cell_contents == 0
    assert methods.get_collate("ETC", 2).__closure__[0].cell_contents == 1

    cfg = default_cfg.clone()
    cfg.merge_from_file(PRESET)
    logger = setup_logger()
    logger.addHandler(caplog.handler)
    try:
        # ETC: the port's window eval on the val split
        etc = ETC(build_encoder("resnet18dilated"), K, fc_dim=512,
                  raft_iters=1)
        layers.init_weights(etc, torch.Generator().manual_seed(0))
        eargs = argparse.Namespace(
            method="ETC", device="cpu", dataroot=vspw_root, num_class=K,
            clip_num=2, dilation_num=0, lesslabel=False, saveroot="",
            max_videos=1)
        train_clip.validate(cfg, eargs, etc.train(), logger)
        assert etc.training and "mIoU" in caplog.text
        caplog.clear()
        # clip_psp: the port's streaming eval on the val split
        model = ClipPSP(build_encoder("resnet18dilated"), K, fc_dim=512)
        layers.init_weights(model, torch.Generator().manual_seed(0))
        pargs = argparse.Namespace(
            method="clip_psp", device="cpu", dataroot=vspw_root,
            num_class=K, clip_num=4, dilation2=[3, 6, 9], lesslabel=False,
            saveroot="", max_videos=1)
        train_clip.validate(cfg, pargs, model.train(), logger)
        assert model.training and "mIoU" in caplog.text
    finally:
        logger.removeHandler(caplog.handler)

"""Non-local 3D (``nonlocal3d``: models/nonlocal_blocks.py,
models/nonlocal3d.py) of the port against the JAX package, f32 on the CPU.

The residual BatchNorm of the non-local block starts with scale 0, and the
block is then the identity: every comparison here first gives it seeded
scale, bias and statistics (``chip_smoke.live_nonlocal_scale``).

(a) ``NLBlockND`` in its four modes, unmasked and masked (the padded keys
    of a zero-masked input excluded), within 1e-5 of the largest output;
(b) ``NonLocal3D`` logits (ResNet-18-dilated, fc_dim 512, 5 classes, 3
    frames of 48x72) within 1e-4 of the largest, exact and bucketed in
    64x128 (B6 on the embedding), and bucketed against exact on the valid
    region; the attention is live (without the block the logits move), and
    a normaliser that counts the padded positions moves the bucketed
    logits past the chip smoke's bar;
(c) the weights both ways: port → ``import_nonlocal3d_state_dict`` →
    ``load_jax_variables`` gives every tensor back, and the importer the
    same tree again;
(d) ``test_clip --method nonlocal3d`` (``test_all``, ``--clip_num 3``)
    against the JAX CLI on a 10-frame video, exact and ``--width_bucket
    64``: the PNGs identical but at near-ties (a pixel whose averaged
    probabilities' top-2 margin is below 1e-5 may fall either way; counted,
    at most 4, and then mIoU and VC within 1e-3, else equal);
(e) the training curve: 3 steps of the clip trainer's step against the
    JAX trainer's, rtol 1e-2 (tests/test_torch_train_ocr_netwarp.py's bar).
"""

import argparse
import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from cvpr2021_vspw_implement_tpu.config import cfg as jax_default_cfg
from cvpr2021_vspw_implement_tpu.methods import build_method as jax_build
from cvpr2021_vspw_implement_tpu.models.import_torch import \
    import_nonlocal3d_state_dict
from cvpr2021_vspw_implement_tpu.models.nonlocal_blocks import \
    NLBlockND as JaxNLBlockND
from cvpr2021_vspw_implement_tpu.test_clip import evaluate_clip
from cvpr2021_vspw_implement_tpu_torch import methods, test_clip
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.data import make_synthetic_vspw
from cvpr2021_vspw_implement_tpu_torch.models import layers
from cvpr2021_vspw_implement_tpu_torch.models import nonlocal_blocks as nlb
from cvpr2021_vspw_implement_tpu_torch.ops import masked
from test_torch_netwarp import PRESET
from test_torch_train_ocr_netwarp import _jax_curve, _port_curve
from torch_port_util import (assert_trees_equal, numpy_tree,
                             perturb_port_batchnorm, to_nchw, to_nhwc)

K, H, W, T = 5, 48, 72, 3
PAD = (64, 128)


def _close(got, want, bar=1e-4):
    assert np.abs(got - want).max() <= bar * max(1.0, np.abs(want).max())


# (a) the block

def _block_variables(block):
    """The JAX NLBlockND tree of a port block (Dense kernels [in, out])."""
    def dense(conv):
        w = conv.weight.detach().numpy()
        return {"kernel": w.reshape(w.shape[0], -1).T,
                "bias": conv.bias.detach().numpy()}
    params = {name: dense(getattr(block, name))
              for name in ("g", "theta", "phi") if hasattr(block, name)}
    if hasattr(block, "W_f"):
        params["W_f"] = dense(block.W_f[0])
    params["W_z"] = dense(block.W_z[0])
    bn = block.W_z[1]
    params["W_z_bn"] = {"scale": bn.weight.detach().numpy(),
                        "bias": bn.bias.detach().numpy()}
    return {"params": params, "batch_stats": {"W_z_bn": {
        "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}}}


@pytest.mark.parametrize("valid", [None, (2, 3)])
@pytest.mark.parametrize("mode", nlb.MODES)
def test_nlblock_matches_jax(mode, valid):
    c, t, h, w = 16, 2, 3, 5
    block = nlb.NLBlockND(c, mode=mode, dimension=3)
    layers.init_weights(block, torch.Generator().manual_seed(1))
    chip_smoke.live_nonlocal_scale(torch, block, seed=2)
    block.eval()
    x = np.random.default_rng(3).normal(size=(2, t, h, w, c)).astype(
        np.float32)
    vm = None
    if valid is not None:
        x[:, :, valid[0]:] = 0
        x[:, :, :, valid[1]:] = 0
        rows = np.arange(h)[:, None] < valid[0]
        cols = np.arange(w)[None, :] < valid[1]
        vm = jnp.asarray(np.broadcast_to(rows & cols, (t, h, w)))
    variables = jax.tree_util.tree_map(jnp.asarray, _block_variables(block))
    want = np.asarray(JaxNLBlockND(c, mode=mode).apply(
        variables, jnp.asarray(x), valid_mask=vm))
    with torch.no_grad():
        got = block(torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(x, -1, 1))), valid_hw=valid)
    _close(np.moveaxis(got.numpy(), 1, -1), want, 1e-5)
    assert np.abs(want - x).max() > 1e-2 * np.abs(x).max()  # not identity


# (b) the model

def _args(**kw):
    ns = argparse.Namespace(num_class=K, method="nonlocal3d", clip_num=T,
                            dilation_num=0, dilation2="3,6,9",
                            deepsup_scale=0.4)
    for key, v in kw.items():
        setattr(ns, key, v)
    return ns


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX cfg, JAX model, variables, port model in eval mode)."""
    cfg = jax_default_cfg.clone()
    cfg.MODEL.arch_encoder = "resnet18dilated"
    cfg.MODEL.fc_dim = 512
    cfg.TPU.compute_dtype = "float32"
    jmodel, _ = jax_build("nonlocal3d", cfg, _args())
    port, _ = methods.build_method("nonlocal3d", _pcfg(), _args())
    layers.init_weights(port, torch.Generator().manual_seed(0))
    perturb_port_batchnorm(port, 1)
    chip_smoke.live_nonlocal_scale(torch, port, seed=2)
    port.eval()
    with torch.no_grad():
        logits = port(_window(0))
        port.last_layer.bias.sub_(logits.mean((0, 1, 3, 4)))
    variables = jax.tree_util.tree_map(
        jnp.asarray, import_nonlocal3d_state_dict(port.state_dict()))
    return cfg, jmodel, variables, port


def _frames(seed):
    """[T, 1, H, W, 3]: a drifting random pattern plus noise."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(1, H, W, 3))
    return np.stack([np.roll(base, (t, 2 * t), (1, 2))
                     + 0.2 * rng.normal(size=base.shape)
                     for t in range(T)]).astype(np.float32)


def _window(seed):
    return to_nchw(_frames(seed))


@functools.lru_cache(maxsize=None)
def _logits(bucketed):
    """(port logits, JAX logits [T, B, h, w, K]) of one window."""
    _, jmodel, variables, port = _models()
    x = _frames(4)
    if not bucketed:
        want = jax.jit(lambda v, a: jmodel.apply(v, a))(variables,
                                                         jnp.asarray(x))
        with torch.no_grad():
            got = port(to_nchw(x))
        return got, np.asarray(want)
    xp = np.zeros((T, 1, *PAD, 3), np.float32)
    xp[:, :, :H, :W] = x
    want = jax.jit(lambda v, a, hv, wv: jmodel.apply(v, a, valid_hw=(hv, wv)))(
        variables, jnp.asarray(xp), jnp.int32(H), jnp.int32(W))
    with torch.inference_mode():
        got = port(to_nchw(xp), valid_hw=(H, W))
    return got, np.asarray(want)


@pytest.mark.parametrize("bucketed", [False, True])
def test_logits_match_jax(bucketed):
    got, want = _logits(bucketed)
    _close(to_nhwc(got), want)


def test_bucketed_equals_exact_and_reads_the_attention(monkeypatch):
    exact, _ = _logits(False)
    bucketed, _ = _logits(True)
    fv = masked.feature_valid(*bucketed.shape[-2:], (H, W), PAD)
    assert fv == tuple(exact.shape[-2:])
    crop = bucketed[..., :fv[0], :fv[1]]
    scale = exact.abs().max().item()
    assert (crop - exact).abs().max().item() <= 1e-4 * scale
    port = _models()[3]
    with torch.no_grad():
        identity = copy.deepcopy(port)
        identity.nonlocalblock.W_z[1].weight.zero_()
        identity.nonlocalblock.W_z[1].bias.zero_()
        moved = (identity(_window(4)) - exact).abs().max().item()
    assert moved > 1e-2 * scale
    # the planted fault of the chip smoke: the dot normaliser counts the
    # padded positions
    monkeypatch.setattr(nlb, "true_positions",
                        lambda spatial, valid_hw: int(np.prod(spatial)))
    xp = masked.pad_to(_window(4), PAD)
    with torch.inference_mode():
        planted = port(xp, valid_hw=(H, W))[..., :fv[0], :fv[1]]
    assert (planted - exact).abs().max().item() > 1e-3 * scale


# (c) the weights

def test_weights_round_trip():
    _, _, variables, port = _models()
    back = load_jax_variables(
        methods.build_method("nonlocal3d", _pcfg(), _args())[0],
        numpy_tree(variables))
    want, got = port.state_dict(), back.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    again = numpy_tree(import_nonlocal3d_state_dict(got))
    assert_trees_equal(again["params"], numpy_tree(variables["params"]))
    assert_trees_equal(again["batch_stats"],
                       numpy_tree(variables["batch_stats"]))


def _pcfg():
    pcfg = port_default_cfg.clone()
    pcfg.merge_from_file(PRESET)
    return pcfg


# (d) the CLI

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nonlocal3d") / "vspw")
    make_synthetic_vspw(root, 1, 10, (H, W), K, seed=7)
    return root


def _record_flushes(records, monkeypatch):
    """Keep each flushed frame's index and the top-2 margin of its averaged
    probabilities (``test_clip.frame_pred``), in flush order."""
    frame_pred, test_all = test_clip.frame_pred, test_clip._test_all
    margins = []

    def recorded_pred(acc, n):
        top = (acc / n).topk(2, dim=1).values[0]
        margins.append((top[0] - top[1]).numpy())
        return frame_pred(acc, n)

    def recorded_test_all(*args, **kwargs):
        for item in test_all(*args, **kwargs):
            records.append((item[0], margins[-1]))
            yield item
    monkeypatch.setattr(test_clip, "frame_pred", recorded_pred)
    monkeypatch.setattr(test_clip, "_test_all", recorded_test_all)


@pytest.mark.parametrize("bucket", [0, 64])
def test_cli_matches_jax(root, tmp_path, bucket, monkeypatch):
    cfg, _, variables, port = _models()
    args = _args(dataroot=root, split="val", vc_clip_num=8, lesslabel=False,
                 load="", is_save=True, saveroot=str(tmp_path / "jax"),
                 width_bucket=bucket)
    jm, _ = evaluate_clip(cfg, args, variables=variables, is_save=True)
    ckpt = str(tmp_path / "model.pth")
    torch.save(port.state_dict(), ckpt)
    flushes = []
    _record_flushes(flushes, monkeypatch)
    pm, _ = test_clip.main([
        "--cfg", PRESET, "--dataroot", root, "--num_class", str(K),
        "--method", "nonlocal3d", "--clip_num", str(T), "--width_bucket",
        str(bucket), "--load", ckpt, "--is_save", "--saveroot",
        str(tmp_path / "port"), "--device", "cpu"])
    jdir = tmp_path / "jax" / "video_000"
    pdir = tmp_path / "port" / "video_000"
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names and len(names) == 10
    # test_all flushes frames 1-8 as their third window passes, then frames
    # 0 and 9, each seen twice, at the video's end
    assert [i for i, _ in flushes] == [1, 2, 3, 4, 5, 6, 7, 8, 0, 9]
    classes, differ, excused = set(), 0, 0
    for i, margin in flushes:
        a = np.asarray(Image.open(jdir / names[i]))
        b = np.asarray(Image.open(pdir / names[i]))
        differ += int((a != b).sum())
        excused += int(((a != b) & (margin < 1e-5)).sum())
        classes |= set(np.unique(a).tolist())
    print(f"\nnonlocal3d CLI, bucket {bucket}: PNGs differ at {differ} "
          f"pixels, {excused} of them near-ties; mIoU {pm['mIoU']} (JAX "
          f"{jm['mIoU']}), VC {pm['VC']} (JAX {jm['VC']})")
    assert len(classes) > 1, "the predictions hold one class"
    assert differ == excused <= 4
    bar = 1e-3 if differ else 1e-12
    assert pm["mIoU"] == pytest.approx(jm["mIoU"], abs=bar)
    assert pm["VC"] == pytest.approx(jm["VC"], abs=bar)


# (e) the training curve

def test_curve_matches_jax():
    cfg, jmodel, variables, port = _models()
    _, jloss = jax_build("nonlocal3d", cfg, _args())
    model, loss = methods.build_method("nonlocal3d", _pcfg(), _args())
    model.load_state_dict(port.state_dict())
    with torch.no_grad():
        # the classifier starts small (logits of a few units), as the
        # curves of tests/test_torch_train_ocr_netwarp.py
        model.last_layer.weight.mul_(0.1)
    start = numpy_tree(import_nonlocal3d_state_dict(model.state_dict()))
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(3):
        img = rng.standard_normal((T, 2, 48, 48, 3)).astype(np.float32)
        lab = rng.integers(0, K, (T, 2, 48, 48)).astype(np.int32)
        lab[:, :, 0, :3] = 255
        batches.append({"img": img, "labels": lab})
    want, _ = _jax_curve(jmodel, start, jloss, batches)
    got = _port_curve(model.train(), loss, batches)
    print(f"\nnonlocal3d: port losses {got[:, 0]}, JAX losses {want[:, 0]}")
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-2)
    np.testing.assert_allclose(got[:, 1], want[:, 1], atol=1e-2)
    assert np.ptp(want[:, 0]) > 1e-3 * abs(want[0, 0])

"""NetWarp (``netwarp``, ``netwarp_ocr``) and ``etc_ocr`` eval of the port
against the JAX package, f32 on the CPU.

ResNet-18-dilated, fc_dim 512, 5 classes, RAFT at 2 refinements with its
flow head scaled by 0.1 (a trained-like step, as tests/test_torch_raft.py
sets it).  Weights are a seeded port init with BatchNorm statistics
perturbed and NetWarp's blend weights (w0_*, w1_*; at init 1 and 0, which
would leave the warped features unread) set to seeded values in [0.3, 0.7]
(``chip_smoke.live_netwarp_blend``), carried to JAX through
``import_netwarp_state_dict`` / ``import_etc_state_dict``; the classifier's
bias evens out the classes' mean logits on a random input (else one class
wins every pixel and a PNG comparison says little).  Frames of 48x72 go
into the 64x128 bucket.

(a) ``resize_nearest_rt`` against JAX (exact), and equal to
    ``resize_nearest`` of the crop;
(b) the shared /8-pad emulation (``models/raft/raft.py::bucketed_flow``)
    through ``NetWarp._flow`` bucketed: against JAX ``_flow_masked`` and
    the port's exact ``_flow`` on the valid region (1e-3 px);
(c) ``FlowCNN``, and ``NetWarp`` and ``NetWarp(ocr=True)`` logits (the
    latter in training mode too, main and DSN) against JAX (within 1e-4 of
    the largest logit), and the logits move when the warp is taken out
    (w0_1 = w1_1 = 0) or its flow negated, so these comparisons hold it;
(d) the streaming building blocks (``encode_frame`` + ``fuse_pair``) equal
    to the window forward, exact and bucketed;
(e) ``test_clip --method netwarp`` / ``netwarp_ocr`` (pair streaming) and
    ``--method etc_ocr`` (windows) against the JAX CLI on a 10-frame video,
    exact and bucketed: identical PNGs, equal mIoU and VC.
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
from cvpr2021_vspw_implement_tpu.models import layers as jlayers
from cvpr2021_vspw_implement_tpu.models.import_torch import FUSED_IMPORTERS
from cvpr2021_vspw_implement_tpu.models.netwarp import FlowCNN as JaxFlowCNN
from cvpr2021_vspw_implement_tpu.ops import interpolate as jinterp
from cvpr2021_vspw_implement_tpu.ops import masked as jmasked
from cvpr2021_vspw_implement_tpu.test_clip import evaluate_clip
from cvpr2021_vspw_implement_tpu_torch import test_clip
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.data import make_synthetic_vspw
from cvpr2021_vspw_implement_tpu_torch.methods import build_method
from cvpr2021_vspw_implement_tpu_torch.models import layers
from cvpr2021_vspw_implement_tpu_torch.ops import masked
from cvpr2021_vspw_implement_tpu_torch.ops.interpolate import resize_nearest
from torch_port_util import perturb_port_batchnorm, to_nchw, to_nhwc

K, H, W = 5, 48, 72
PAD = (64, 128)
PRESET = os.path.join(os.path.dirname(__file__), os.pardir,
                      "cvpr2021_vspw_implement_tpu_torch", "config", "presets",
                      "vsp-resnet18dilated-ppm_deepsup_clip.yaml")


def _close(got, want, bar=1e-4):
    assert np.abs(got - want).max() <= bar * max(1.0, np.abs(want).max())


# (a) the nearest resize at the true sizes

@pytest.mark.parametrize("in_valid,out_valid", [
    ((48, 72), (6, 9)), ((45, 61), (6, 8)), ((6, 9), (48, 72))])
def test_resize_nearest_rt_matches_jax_and_crop(in_valid, out_valid):
    in_pad = (masked.bucket_size(in_valid[0], 8),
              masked.bucket_size(in_valid[1], 16))
    out_pad = (masked.bucket_size(out_valid[0], 8),
               masked.bucket_size(out_valid[1], 16))
    x = np.random.default_rng(0).normal(size=(2, *in_valid, 3)).astype(
        np.float32)
    xp = np.asarray(jmasked.pad_to(jnp.asarray(x), in_pad))
    want = np.asarray(jax.jit(jmasked.resize_nearest_rt,
                              static_argnums=(1,))(
        jnp.asarray(xp), out_pad, in_valid, out_valid))
    got = masked.resize_nearest_rt(to_nchw(xp), out_pad, in_valid,
                                   out_valid)
    assert got.shape[-2:] == out_pad
    np.testing.assert_array_equal(to_nhwc(got), want)
    hv, wv = out_valid
    np.testing.assert_array_equal(
        got[..., :hv, :wv].numpy(),
        resize_nearest(to_nchw(x), out_valid).numpy())
    np.testing.assert_array_equal(
        to_nhwc(resize_nearest(to_nchw(x), out_valid)),
        np.asarray(jinterp.resize_nearest(jnp.asarray(x), out_valid)))
    assert not got[..., hv:, :].any() and not got[..., wv:].any()


# the models

def _args(method, **kw):
    ns = argparse.Namespace(
        num_class=K, method=method, clip_num=2, dilation_num=0,
        dilation2="3,6,9", deepsup_scale=0.4, st_weight=0.1, allsup=False,
        allsup_scale=0.3, linear_combine=False, distsoftmax=False,
        distnearest=False, temp=3.0, max_distances=[2], fix=False,
        psp_weight=False, use_memory=False, memory_num=8, clipocr_all=False)
    for key, v in kw.items():
        setattr(ns, key, v)
    return ns


def _pair(seed, b=1, h=H, w=W):
    """[prev, target]: the target a shifted, noisy copy of prev."""
    rng = np.random.default_rng(seed)
    prev = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    target = np.roll(prev, (1, 2), axis=(1, 2)) + 0.1 * rng.normal(
        size=prev.shape).astype(np.float32)
    return np.stack([prev, target])


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _models(method):
    """(JAX cfg, JAX args, JAX model, variables, port model)."""
    cfg = jax_default_cfg.clone()
    cfg.MODEL.arch_encoder = "resnet18dilated"
    cfg.MODEL.fc_dim = 512
    cfg.TPU.compute_dtype = "float32"
    cfg.TPU.raft_iters = 2
    pcfg = port_default_cfg.clone()
    pcfg.merge_from_file(PRESET)
    pcfg.TPU.raft_iters = 2
    args = _args(method)
    jmodel, _ = jax_build(method, cfg, args)
    port, _ = build_method(method, pcfg, args)
    layers.init_weights(port, torch.Generator().manual_seed(0))
    perturb_port_batchnorm(port, 1)
    if method.startswith("netwarp"):
        chip_smoke.live_netwarp_blend(torch, port, seed=2)
    with torch.no_grad():
        head = port.raft.update_block.flow_head.conv2
        head.weight.mul_(0.1)
        head.bias.mul_(0.1)
        cls = port.head if method == "netwarp_ocr" else (
            port.conv_last_[-1] if method == "netwarp" else port.conv_last_)
        (logits,) = port.eval()(_nchw(_pair(0)))
        cls.bias.sub_(logits.mean((0, 2, 3)))
    return (cfg, args, jmodel, FUSED_IMPORTERS[method](port.state_dict()),
            port)


@functools.lru_cache(maxsize=None)
def _cached(method):
    return (method, *_models(method))


@pytest.fixture(scope="module", params=["netwarp", "netwarp_ocr"])
def netwarp(request):
    return _cached(request.param)


# (b) the bucketed flow (the decoder does not reach it: netwarp only)

def test_bucketed_flow_matches_jax_and_exact():
    _, _, _, jmodel, variables, port = _cached("netwarp")
    x = _pair(2)
    padded = np.zeros((2, 1, *PAD, 3), np.float32)
    padded[:, :, :H, :W] = x
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, t, p: jmodel.apply(
            v, t, p, False, (H, W), method=jmodel._flow_masked))(
                variables, jnp.asarray(padded[1]), jnp.asarray(padded[0])))
    port.eval()
    pp = _nchw(padded)
    with torch.inference_mode():
        got = port._flow(pp[1], pp[0], valid_hw=(H, W))
        exact = port._flow(_nchw(x[1]), _nchw(x[0]))
    assert not got[..., H:, :].any() and not got[..., W:].any()
    np.testing.assert_allclose(to_nhwc(got)[:, :H, :W], want[:, :H, :W],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[..., :H, :W].numpy(), exact.numpy(),
                               atol=1e-3, rtol=0)
    assert np.abs(exact.numpy()).max() > 0.1     # a flow that moves


# (c) the models against JAX

def test_flowcnn_matches_jax():
    _, _, _, _, variables, port = _cached("netwarp")
    rng = np.random.default_rng(3)
    img1, img2 = (rng.uniform(0, 255, (2, 16, 24, 3)).astype(np.float32)
                  for _ in range(2))
    flow = rng.normal(0, 2, (2, 16, 24, 2)).astype(np.float32)
    jvars = {"params": variables["params"]["flowcnn"],
             "batch_stats": variables["batch_stats"]["flowcnn"]}
    want = np.asarray(JaxFlowCNN().apply(
        jvars, *(jnp.asarray(a) for a in (img1, img2, flow)), False))
    with torch.no_grad():
        got = port.flowcnn.eval()(to_nchw(img1), to_nchw(img2),
                                  to_nchw(flow))
    _close(to_nhwc(got), want)


# training mode for netwarp_ocr, whose DSN logits carry the quirk of the
# [target, prev] order (the curves of tests/test_torch_train_ocr_netwarp.py
# hold both trainers)
@pytest.mark.parametrize("method,train", [("netwarp", False),
                                          ("netwarp_ocr", False),
                                          ("netwarp_ocr", True)])
def test_netwarp_logits_match_jax(method, train):
    _, _, _, jmodel, variables, port = _cached(method)
    # a training forward moves BatchNorm's running statistics: a copy
    port = copy.deepcopy(port) if train else port
    x = _pair(4)
    jlayers.set_dropout_override(0.0)
    layers.set_dropout_override(0.0)
    try:
        with jax.default_matmul_precision("highest"):
            out = jax.jit(lambda v, a: jmodel.apply(
                v, a, train=train, mutable=["batch_stats"] if train else False,
                rngs={"dropout": jax.random.PRNGKey(0)}))(
                    variables, jnp.asarray(x))
        want = out[0] if train else out
        got = port.train(train)(_nchw(x))
    finally:
        jlayers.set_dropout_override(None)
        layers.set_dropout_override(None)
    assert len(got) == len(want) == (2 if train else 1)
    for g, w in zip(got, want):
        _close(to_nhwc(g.detach()), np.asarray(w))


@pytest.mark.parametrize("method", ["netwarp", "netwarp_ocr"])
def test_logits_read_the_warp(method, monkeypatch):
    """The blend weights are live: without the warped features, or with
    the flow negated, the logits move by more than 1e-2 of the largest."""
    from cvpr2021_vspw_implement_tpu_torch.models import netwarp as nw

    _, _, _, _, _, port = _cached(method)
    port.eval()
    x = _nchw(_pair(4))
    with torch.no_grad():
        (base,) = port(x)
        unwarped = copy.deepcopy(port)
        unwarped.w0_1.zero_()
        unwarped.w1_1.zero_()
        (no_warp,) = unwarped(x)
        flowwarp = nw.flowwarp
        monkeypatch.setattr(nw, "flowwarp", lambda f, flow, **kw: flowwarp(
            f, -flow, **kw))
        (negated,) = port(x)
    scale = base.abs().max().item()
    print(f"\n{method}: largest logit {scale:.3e}, moved by "
          f"{(no_warp - base).abs().max().item():.3e} without the warp, "
          f"{(negated - base).abs().max().item():.3e} with the flow negated")
    assert (no_warp - base).abs().max().item() > 1e-2 * scale
    assert (negated - base).abs().max().item() > 1e-2 * scale


# (d) streaming against the window forward

@pytest.mark.parametrize("bucketed", [False, True])
def test_fuse_pair_equals_the_window_forward(netwarp, bucketed):
    _, _, _, _, _, port = netwarp
    port.eval()
    x = _pair(5)
    (want,) = port(_nchw(x))
    imgs = _nchw(x)[:, 0:1]
    kw = {}
    if bucketed:
        imgs = masked.pad_to(imgs, PAD)
        kw = {"valid_hw": (H, W)}
    with torch.inference_mode():
        prev, target = (port.encode_frame(imgs[i], **kw) for i in (0, 1))
        got, _ = port.fuse_pair(imgs[1], imgs[0], target[0], prev[0],
                                prev[1], target[2] if port.ocr else None,
                                **kw)
    if bucketed:
        fv = masked.feature_valid(*got.shape[-2:], (H, W), PAD)
        assert fv == tuple(want.shape[-2:])
        got = got[..., :fv[0], :fv[1]]
    _close(got.numpy(), want.detach().numpy())


# (e) the CLI

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("netwarp") / "vspw")
    make_synthetic_vspw(root, 1, 10, (H, W), K, seed=7)
    return root


def assert_same_pngs(pdir, jdir):
    names = sorted(os.listdir(jdir))
    assert len(names) == 10 and sorted(os.listdir(pdir)) == names
    classes = set()
    for n in names:
        a, b = Image.open(os.path.join(jdir, n)), Image.open(
            os.path.join(pdir, n))
        assert b.mode == "P" and a.getpalette() == b.getpalette()
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        classes |= set(np.unique(np.asarray(a)).tolist())
    assert len(classes) > 1, "the predictions hold one class"


@pytest.mark.parametrize("method", ["netwarp", "netwarp_ocr", "etc_ocr"])
@pytest.mark.parametrize("bucket", [0, 64])
def test_cli_matches_jax(root, tmp_path, method, bucket):
    cfg, args, _, variables, port = _models(method)
    for key, v in dict(dataroot=root, split="val", vc_clip_num=8,
                       lesslabel=False, load="", is_save=True,
                       saveroot=str(tmp_path / "jax"),
                       width_bucket=bucket).items():
        setattr(args, key, v)
    with jax.default_matmul_precision("highest"):
        jm, _ = evaluate_clip(cfg, args, variables=variables, is_save=True)
    ckpt = str(tmp_path / "model.pth")
    torch.save(port.state_dict(), ckpt)
    pm, _ = test_clip.main([
        "--cfg", PRESET, "--dataroot", root, "--num_class", str(K),
        "--method", method, "--clip_num", "2", "--width_bucket", str(bucket),
        "--load", ckpt, "--is_save", "--saveroot", str(tmp_path / "port"),
        "--device", "cpu", "TPU.raft_iters", "2"])
    assert_same_pngs(str(tmp_path / "port" / "video_000"),
                     str(tmp_path / "jax" / "video_000"))
    assert pm["mIoU"] == pytest.approx(jm["mIoU"], abs=1e-12)
    assert pm["VC"] == pytest.approx(jm["VC"], abs=1e-12)
    if method != "etc_ocr":
        assert pm["buckets"] == ([PAD] if bucket else [])

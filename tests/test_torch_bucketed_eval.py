"""Width-bucketed masked eval of the port against the JAX package.

ResNet-18-dilated ClipPSP (fc_dim 512, 5 classes) and RAFT on frames of
48 x 61-90 padded to their buckets, the same seeded numpy inputs and weights
on both sides, f32 on the CPU:

(a) ``feature_valid``, ``bucket_hw``, ``pad_to`` and the ``*_rt`` ops
    against JAX ``ops/masked.py`` (atol 1e-6: one or two f32 products per
    output, summed in another order);
(b) B6's plain version bitwise equal to JAX ``mask_valid`` and to the
    Pallas ``band_zero_inplace`` in interpret mode;
(c) the masked trunk on the valid region against the port's unpadded run
    and JAX's masked trunk (atol 1e-4: a deep conv stack summed in another
    order);
(d) the bucketed engine against JAX's (C5, stats and logits rtol/atol
    1e-4, identical predictions), against the port's exact run, and its
    bucket count;
(e) the masked RAFT against JAX ``RAFT.apply(..., valid_hw=)`` and the
    port's exact run (flow atol 1e-3 px, the flow head scaled to a
    trained-like step as in tests/test_torch_raft.py);
(f) the CLIs on a fixture with two widths: ``test_clip`` gives the JAX
    CLI's PNGs under each ``--eval_policy`` (the JAX CLI's default,
    bucketed, run once: tests/test_masked_eval.py holds its exact PNGs
    equal to those), ``tc_cal --width_bucket 64``
    the JAX TC within 1e-3 (random RAFT weights: a nearest warp can move a
    label where the flow sits within rounding of a half pixel), and the
    window methods at the default bucket give their exact-shape PNGs.
"""

import argparse
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cvpr2021_vspw_implement_tpu import tc_cal as jax_tc_cal
from cvpr2021_vspw_implement_tpu.config import cfg as jax_default_cfg
from cvpr2021_vspw_implement_tpu.methods import build_method
from cvpr2021_vspw_implement_tpu.models.import_torch import (
    import_clip_psp_state_dict, import_raft_state_dict)
from cvpr2021_vspw_implement_tpu.models.raft import RAFT as JaxRAFT
from cvpr2021_vspw_implement_tpu.ops import masked as jmasked
from cvpr2021_vspw_implement_tpu.ops.pallas.band_zero import \
    band_zero_inplace
from cvpr2021_vspw_implement_tpu.serving import \
    ClipPSPBucketEngine as JaxBucketEngine
from cvpr2021_vspw_implement_tpu.serving import \
    ClipPSPStreamer as JaxClipPSPStreamer
from cvpr2021_vspw_implement_tpu.test_clip import evaluate_clip
from cvpr2021_vspw_implement_tpu_torch import tc_cal, test_clip
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.data import make_synthetic_vspw
from cvpr2021_vspw_implement_tpu_torch.models.clip_psp import build_clip_psp
from cvpr2021_vspw_implement_tpu_torch.models.layers import init_weights
from cvpr2021_vspw_implement_tpu_torch.models.raft import RAFT
from cvpr2021_vspw_implement_tpu_torch.ops import masked
from cvpr2021_vspw_implement_tpu_torch.ops.band_zero import (band_zero,
                                                             band_zero_plain)
from cvpr2021_vspw_implement_tpu_torch.serving import (ClipPSPBucketEngine,
                                                       ClipPSPStreamer)
from torch_port_util import perturb_batchnorm, to_nchw, to_nhwc

K, H = 5, 48
PRESET = os.path.join(os.path.dirname(__file__), os.pardir,
                      "cvpr2021_vspw_implement_tpu_torch", "config", "presets",
                      "vsp-resnet18dilated-ppm_deepsup_clip.yaml")


# (a) sizes, padding and the *_rt ops

@pytest.mark.parametrize("hw,bucket", [((480, 853), 64), ((480, 853), 32),
                                       ((477, 853), 64), ((481, 640), 64),
                                       ((48, 70), 64), ((480, 896), 64)])
def test_bucket_hw_matches_jax(hw, bucket):
    assert masked.bucket_hw(*hw, bucket) == jmasked.bucket_hw(*hw, bucket)


@pytest.mark.parametrize("feat", [(60, 112), (30, 56), (240, 448), (8, 16)])
def test_feature_valid_matches_jax(feat):
    for valid in ((480, 853), (449, 833), (480, 896), (48, 70)):
        pad = masked.bucket_hw(*valid)
        want = jmasked.feature_valid(*feat, valid, pad)
        assert masked.feature_valid(*feat, valid, pad) == tuple(
            int(v) for v in want)


def test_pad_to_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 45, 61, 3)).astype(
        np.float32)
    got = masked.pad_to(torch.from_numpy(x).permute(0, 3, 1, 2), (64, 128))
    assert got.is_contiguous() and got.shape == (2, 3, 64, 128)
    np.testing.assert_array_equal(
        to_nhwc(got), np.asarray(jmasked.pad_to(jnp.asarray(x), (64, 128))))


@pytest.mark.parametrize("in_hw,out_hw,ac", [
    ((30, 53), (60, 106), False),
    ((30, 53), (60, 106), True),
    ((17, 29), (480, 853), False),
    ((64, 96), (17, 23), False),
    ((1, 7), (8, 15), False),
])
def test_resize_bilinear_rt_matches_jax(in_hw, out_hw, ac):
    x = np.random.default_rng(1).normal(size=(2, *in_hw, 5)).astype(
        np.float32)
    in_pad = (masked.bucket_size(in_hw[0], 8), masked.bucket_size(in_hw[1], 8))
    out_pad = (masked.bucket_size(out_hw[0], 8),
               masked.bucket_size(out_hw[1], 8))
    xp = np.asarray(jmasked.pad_to(jnp.asarray(x), in_pad))
    want = jax.jit(jmasked.resize_bilinear_rt, static_argnums=(1, 2, 3, 4))(
        jnp.asarray(xp), out_pad, in_hw, out_hw, ac)
    got = masked.resize_bilinear_rt(to_nchw(xp), out_pad, in_hw, out_hw,
                                    align_corners=ac)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("in_hw,scale", [((60, 107), 1), ((60, 107), 2),
                                         ((60, 107), 6), ((13, 21), 3)])
def test_adaptive_avg_pool2d_rt_matches_jax(in_hw, scale):
    x = np.random.default_rng(2).normal(size=(2, *in_hw, 7)).astype(
        np.float32)
    pad = (masked.bucket_size(in_hw[0], 16), masked.bucket_size(in_hw[1], 16))
    xp = np.asarray(jmasked.pad_to(jnp.asarray(x), pad))
    want = jax.jit(jmasked.adaptive_avg_pool2d_rt, static_argnums=(1, 2))(
        jnp.asarray(xp), scale, in_hw)
    got = masked.adaptive_avg_pool2d_rt(to_nchw(xp), scale, in_hw)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_global_avg_pool_rt_matches_jax():
    x = np.random.default_rng(3).normal(size=(3, 11, 19, 4)).astype(
        np.float32)
    xp = np.asarray(jmasked.pad_to(jnp.asarray(x), (16, 24)))
    want = jmasked.global_avg_pool_rt(jnp.asarray(xp), (11, 19))
    got = masked.global_avg_pool_rt(to_nchw(xp), (11, 19))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-6,
                               rtol=0)


# (b) B6's plain version

@pytest.mark.parametrize("feat,valid", [
    ((64, 112, 256), (480, 853)),
    ((32, 56, 128), (480, 853)),
    ((64, 112, 256), (449, 833)),
    ((64, 112, 256), (512, 896)),
    ((64, 112, 256), (457, 896)),
])
def test_band_zero_plain_matches_jax(feat, valid):
    """The five cases of tests/test_pallas_band.py (NHWC there, NCHW
    here): bitwise equal to ``mask_valid`` and to the Pallas kernel."""
    hf, wf, c = feat
    pad_hw = (512, 896)
    x = np.random.default_rng(0).standard_normal((2, hf, wf, c)).astype(
        np.float32)
    hv, wv = masked.feature_valid(hf, wf, valid, pad_hw)
    want = np.asarray(jmasked.mask_valid(jnp.asarray(x), (hv, wv)))
    pallas = np.asarray(band_zero_inplace(jnp.asarray(x), hv, wv, pad_hw,
                                          interpret=True))
    np.testing.assert_array_equal(pallas, want)
    t = to_nchw(x)
    before = band_zero.launches
    assert band_zero_plain(t.clone(), hv, wv).equal(to_nchw(want))
    got = masked.mask_valid(t, (hv, wv))
    assert got is t and band_zero.launches == before
    np.testing.assert_array_equal(to_nhwc(got), want)


def test_band_zero_refuses_strided_and_grad_tensors():
    x = torch.zeros(1, 4, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        band_zero(x.transpose(2, 3), 3, 5)
    with pytest.raises(ValueError, match="requires grad"):
        band_zero(x.clone().requires_grad_(), 3, 5)
    with pytest.raises(ValueError, match="outside"):
        band_zero(x, 9, 5)


# shared weights: a seeded port init carried to the JAX trees by the JAX
# package's importers (no JAX init to compile), BatchNorm statistics
# perturbed on both sides

@pytest.fixture(scope="module")
def clip_psp():
    """R18 ClipPSP of (c), (d) and (f): (JAX cfg, JAX model, variables,
    port model)."""
    cfg = jax_default_cfg.clone()
    cfg.MODEL.arch_encoder = "resnet18dilated"
    cfg.MODEL.fc_dim = 512
    cfg.TPU.compute_dtype = "float32"
    jargs = argparse.Namespace(num_class=K, psp_weight=False,
                               deepsup_scale=0.4)
    jmodel, _ = build_method("clip_psp", cfg, jargs)
    pcfg = port_default_cfg.clone()
    pcfg.MODEL.arch_encoder = "resnet18dilated"
    pcfg.MODEL.fc_dim = 512
    port = build_clip_psp(pcfg, K)
    init_weights(port, torch.Generator().manual_seed(0))
    variables = perturb_batchnorm(
        import_clip_psp_state_dict(port.state_dict()), seed=2)
    return cfg, jmodel, variables, load_jax_variables(port, variables).eval()


@pytest.fixture(scope="module")
def raft():
    """RAFT of (e) and (f), 3 refinements, the flow head scaled by 0.1 (the
    random init moves the flow ~20 px a refinement, where a trained RAFT
    moves a few, and each refinement then amplifies f32 rounding ~8x):
    (JAX model, variables, port model)."""
    port = RAFT(iters=3)
    init_weights(port, torch.Generator().manual_seed(1))
    variables = perturb_batchnorm(import_raft_state_dict(port.state_dict()),
                                  seed=5)
    variables["params"]["update_block"]["flow_head"]["conv2"]["conv"][
        "kernel"] *= 0.1
    return (JaxRAFT(iters=3), variables,
            load_jax_variables(port, variables).eval())


def _frames(seed, w, n=5):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(H, w, 3)).astype(np.float32) for _ in range(n)]


# (c) the masked trunk

def test_masked_trunk_matches_unpadded_and_jax(clip_psp):
    _, jmodel, variables, port = clip_psp
    img = _frames(4, 70, 1)[0][None]                   # [1, 48, 70, 3]
    pad_hw = masked.bucket_hw(H, 70)                   # (64, 128)
    imgp = np.asarray(jmasked.pad_to(jnp.asarray(img), pad_hw))
    with jax.default_matmul_precision("highest"), \
            jmasked.masked_trunk((H, 70), pad_hw):
        jouts = jax.jit(lambda v, x: jmodel.apply(
            v, x, method=lambda m, x: m.encoder(x, train=False)))(
                variables, jnp.asarray(imgp))
    with torch.inference_mode():
        exact = port.encoder(to_nchw(img))
        with masked.masked_trunk(port.encoder, (H, 70), pad_hw):
            outs = port.encoder(to_nchw(imgp))
    assert masked.current_mask() is None
    assert not port.encoder.conv1._forward_pre_hooks
    for e, got, want in zip(exact, outs, jouts):
        hv, wv = masked.feature_valid(*got.shape[-2:], (H, 70), pad_hw)
        assert (hv, wv) == tuple(e.shape[-2:])
        valid = got[..., :hv, :wv]
        np.testing.assert_allclose(valid.numpy(), e.numpy(), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(to_nhwc(valid),
                                   np.asarray(want)[:, :hv, :wv], atol=1e-4,
                                   rtol=0)


# (d) the bucketed engine

def test_bucket_engine_matches_jax(clip_psp):
    _, jmodel, variables, port = clip_psp
    frames = _frames(5, 70)
    pad_hw = (64, 128)
    with torch.inference_mode():
        c5, pooled = port.encode_frame(
            masked.pad_to(to_nchw(frames[0][None]), pad_hw),
            valid_hw=(H, 70))
        fv = masked.feature_valid(*c5.shape[-2:], (H, 70), pad_hw)
        logits = port.fuse_target(c5, pooled, feat_valid=fv)
    with jax.default_matmul_precision("highest"):
        jengine = JaxBucketEngine(jmodel, variables, bucket=64)
        jc5, jpooled = jengine.encode(frames[0])
        jlogits = jax.jit(lambda v, c5, pooled: jmodel.apply(
            v, c5, pooled, feat_valid=fv, method=jmodel.fuse_target))(
                variables, jc5, jpooled)
    hv, wv = fv
    np.testing.assert_array_equal(c5[..., hv:, :].numpy(), 0.0)
    np.testing.assert_array_equal(c5[..., wv:].numpy(), 0.0)
    np.testing.assert_allclose(to_nhwc(c5), np.asarray(jc5), atol=1e-4,
                               rtol=1e-4)
    for got, want in zip(pooled, jpooled):
        np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_allclose(to_nhwc(logits)[:, :hv, :wv],
                               np.asarray(jlogits)[:, :hv, :wv], atol=1e-4,
                               rtol=1e-4)

    dil = [1, 2]
    engine = ClipPSPBucketEngine(port, bucket=64)
    got = dict(ClipPSPStreamer(port, dil, 5, (H, 70), device="cpu",
                               engine=engine).run(iter(frames)))
    with jax.default_matmul_precision("highest"):
        want = dict(JaxClipPSPStreamer(jmodel, variables, dil, 5, (H, 70),
                                       engine=jengine).run(iter(frames)))
    assert sorted(got) == sorted(want) == list(range(5))
    for i in want:
        assert got[i].shape == (H, 70)
        np.testing.assert_array_equal(got[i], want[i])
    assert engine.encode_shapes == jengine.encode_shapes == [pad_hw]


def test_bucket_engine_matches_exact_and_counts_buckets(clip_psp):
    """Two widths share the 128 bucket: one entry in ``encode_shapes``."""
    port = clip_psp[3]
    engine = ClipPSPBucketEngine(port, bucket=64)
    for seed, w in ((6, 70), (7, 90)):
        frames = _frames(seed, w)
        exact = dict(ClipPSPStreamer(port, [1, 2], 5, (H, w),
                                     device="cpu").run(iter(frames)))
        bucketed = dict(ClipPSPStreamer(port, [1, 2], 5, (H, w),
                                        device="cpu",
                                        engine=engine).run(iter(frames)))
        for i in exact:
            np.testing.assert_array_equal(bucketed[i], exact[i])
    assert engine.encode_shapes == [(64, 128)]


# (e) the masked RAFT

def test_masked_raft_matches_jax_and_exact(raft):
    jmodel, variables, port = raft
    rng = np.random.default_rng(0)
    h8, w8 = 48, 72                                # /8-aligned true size
    im1 = rng.uniform(0, 255, (1, h8, w8, 3)).astype(np.float32)
    im2 = np.roll(im1, (1, 2), axis=(1, 2)) + rng.normal(
        0, 4, im1.shape).astype(np.float32)
    pad_hw = masked.bucket_hw(h8, w8)              # (64, 128)
    p1, p2 = (np.asarray(jmasked.pad_to(jnp.asarray(a), pad_hw))
              for a in (im1, im2))
    with jax.default_matmul_precision("highest"):
        jlow, jup = jax.jit(lambda v, a, b: jmodel.apply(
            v, a, b, test_mode=True, valid_hw=(h8, w8)))(
                variables, jnp.asarray(p1), jnp.asarray(p2))
    with torch.inference_mode():
        low, up = port(to_nchw(p1), to_nchw(p2), valid_hw=(h8, w8))
        elow, eup = port(to_nchw(im1), to_nchw(im2))
    for got, exact, want, (hv, wv) in ((low, elow, jlow, (6, 9)),
                                       (up, eup, jup, (h8, w8))):
        valid = got[..., :hv, :wv]
        np.testing.assert_allclose(to_nhwc(valid),
                                   np.asarray(want)[:, :hv, :wv], atol=1e-3,
                                   rtol=0)
        np.testing.assert_allclose(valid.numpy(), exact.numpy(), atol=1e-3,
                                   rtol=0)


# (f) the CLIs

def _jax_args(root, saveroot, **kw):
    ns = argparse.Namespace(
        dataroot=root, split="val", num_class=K, method="clip_psp",
        clip_num=4, dilation_num=0, dilation2="3,6,9", vc_clip_num=8,
        lesslabel=False, use_memory=False, memory_num=8, clipocr_all=False,
        psp_weight=False, deepsup_scale=0.4, st_weight=0.1, load="",
        saveroot=saveroot, is_save=True, width_bucket=64,
        eval_policy="bucketed", exact_min_frames=15000)
    for key, v in kw.items():
        setattr(ns, key, v)
    return ns


@pytest.fixture(scope="module")
def two_widths(tmp_path_factory, clip_psp):
    """A fixture of two videos, 12 frames at 48x70 and 10 at 48x90 (one
    bucket, 64x128), the JAX CLI's metrics and PNGs over it (bucketed), and
    the port checkpoint of the same weights."""
    cfg, _, variables, port = clip_psp
    tmp = tmp_path_factory.mktemp("bucketed_cli")
    root = str(tmp / "vspw")
    make_synthetic_vspw(root, 1, 12, (H, 70), K, seed=7)
    make_synthetic_vspw(str(tmp / "wide"), 1, 10, (H, 90), K, seed=8)
    shutil.copytree(tmp / "wide" / "data" / "video_000",
                    os.path.join(root, "data", "video_001"))
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("video_000\nvideo_001\n")
    jdir = str(tmp / "jax")
    with jax.default_matmul_precision("highest"):
        jm, _ = evaluate_clip(cfg, _jax_args(root, jdir), variables=variables,
                              is_save=True)
    ckpt = str(tmp / "clip_psp.pth")
    torch.save(port.state_dict(), ckpt)
    return root, (jm, jdir), ckpt, tmp


def _assert_same_pngs(pdir, jdir, video):
    names = sorted(os.listdir(os.path.join(jdir, video)))
    assert names and sorted(os.listdir(os.path.join(pdir, video))) == names
    for n in names:
        a = Image.open(os.path.join(jdir, video, n))
        b = Image.open(os.path.join(pdir, video, n))
        assert b.mode == "P" and b.size == a.size
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("policy", ["bucketed", "exact", "auto"])
def test_test_clip_policies_match_jax(two_widths, policy):
    """``auto`` with --exact_min_frames 11 runs the 12-frame 48x70 video
    exactly and the 10-frame 48x90 one bucketed."""
    root, (jm, jdir), ckpt, tmp = two_widths
    out = str(tmp / ("port_" + policy))
    pm, _ = test_clip.main([
        "--cfg", PRESET, "--dataroot", root, "--num_class", str(K),
        "--load", ckpt, "--is_save", "--saveroot", out, "--eval_policy",
        policy, "--exact_min_frames", "11", "--device", "cpu"])
    for video in ("video_000", "video_001"):
        _assert_same_pngs(out, jdir, video)
    assert pm["buckets"] == ([] if policy == "exact" else [(64, 128)])
    assert pm["mIoU"] == pytest.approx(jm["mIoU"], abs=1e-12)
    assert pm["VC"] == pytest.approx(jm["VC"], abs=1e-12)


def test_tc_cal_bucketed_matches_jax(two_widths, raft, monkeypatch):
    """Over the 48x70 video (its /8 pad is a roll of one column inside the
    bucket)."""
    root, (_, preds), _, tmp = two_widths
    _, variables, port = raft
    targs = argparse.Namespace(
        dataroot=root, predroot=preds, split="val", num_class=K,
        max_videos=1, raft_ckpt="", raft_iters=3, allow_random_raft=True,
        width_bucket=64)
    monkeypatch.setattr(jax_tc_cal, "load_raft_variables",
                        lambda path, model: variables)
    with jax.default_matmul_precision("highest"):
        tc_jax = jax_tc_cal.compute_tc(targs)
    ckpt = str(tmp / "raft.pth")
    torch.save(port.state_dict(), ckpt)
    tc_port = tc_cal.main([
        "--dataroot", root, "--predroot", preds, "--num_class", str(K),
        "--max_videos", "1", "--raft_ckpt", ckpt, "--raft_iters", "3",
        "--device", "cpu"])
    assert np.isfinite(tc_port)
    assert abs(tc_port - tc_jax) <= 1e-3


@pytest.mark.parametrize("method,flags", [
    ("our_warp", []), ("ETC", ["--clip_num", "2"]), ("propnet", []),
    ("our_warp_merge", [])])
def test_window_methods_bucketed_give_exact_pngs(two_widths, method, flags):
    """The window methods run bucketed at the CLI's default bucket (both
    videos in 64x128) and give the PNGs of ``--width_bucket 0``."""
    root, _, _, tmp = two_widths
    outs = {}
    for bucket in ("64", "0"):
        out = str(tmp / f"{method}_{bucket}")
        test_clip.main([
            "--cfg", PRESET, "--dataroot", root, "--num_class", str(K),
            "--method", method, *flags, "--max_distances", "2", "--is_save",
            "--saveroot", out, "--width_bucket", bucket, "--device", "cpu"])
        outs[bucket] = out
    for video in ("video_000", "video_001"):
        _assert_same_pngs(outs["64"], outs["0"], video)

"""Width-bucketed window eval of the port (``our_warp`` in its three modes
and ``ETC``) against the JAX package, f32 on the CPU.

Frames of 48x72 go into the 64x128 bucket (features 8x16, valid 6x9), so
the band is real in both axes.  Inputs come from numpy with a seed; the
weights are a seeded port init (ResNet-18-dilated, fc_dim 512, 5 classes,
BatchNorm statistics perturbed) carried to JAX through its importers, and
JAX's side is jitted.

(a) B5's plain versions with ``valid_hw`` against JAX
    ``local_pairwise_dist(valid_hw=)`` then ``warp_one_scale`` (the path
    the JAX package takes when masked), within 1e-5 on the valid region
    (nearest: equal off near-ties), on near-match inputs; against the same
    plain version on the contiguous crop; the band zero; the valid size of
    the whole grid is the call without one; refusals of a valid size
    outside the grid;
(b) ``ClipWarpNet`` in each mode and ``ETC``, bucketed, against JAX
    ``model.apply(..., valid_hw=)`` and against the port's exact run on the
    valid region, logits within 1e-4 of their range;
(c) ``test_clip`` with the default ``--width_bucket 64`` against the JAX
    CLI: identical PNGs, equal mIoU and VC.
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cvpr2021_vspw_implement_tpu.config import cfg as jax_default_cfg
from cvpr2021_vspw_implement_tpu.methods import build_method as jax_build
from cvpr2021_vspw_implement_tpu.models.import_torch import (
    import_clip_warp_state_dict, import_etc_state_dict)
from cvpr2021_vspw_implement_tpu.models.warp_our import \
    warp_one_scale as jax_warp_one_scale
from cvpr2021_vspw_implement_tpu.ops import local_pairwise as jlp
from cvpr2021_vspw_implement_tpu.ops import masked as jmasked
from cvpr2021_vspw_implement_tpu.test_clip import evaluate_clip
from cvpr2021_vspw_implement_tpu_torch import test_clip
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.data import make_synthetic_vspw
from cvpr2021_vspw_implement_tpu_torch.methods import build_method
from cvpr2021_vspw_implement_tpu_torch.models.layers import init_weights
from cvpr2021_vspw_implement_tpu_torch.ops import local_agg, masked
from torch_port_util import (local_agg_inputs, perturb_port_batchnorm,
                             to_nchw, to_nhwc)

K, H, W = 5, 48, 72
PAD = (64, 128)
PRESET = os.path.join(os.path.dirname(__file__), os.pardir,
                      "cvpr2021_vspw_implement_tpu_torch", "config", "presets",
                      "vsp-resnet18dilated-ppm_deepsup_clip.yaml")
MODES = ("sigmoid", "softmax", "nearest")
GAP = 1e-4


# (a) B5's plain versions with a valid size

def _near_ties(dist):
    """[B, H, W]: the two largest window distances are in the image and
    lie within GAP relative (dist: JAX [B, H, W, k, k])."""
    flat = np.sort(np.asarray(dist).reshape(*dist.shape[:3], -1), -1)
    return ((flat[..., -1] < 1e19)
            & (flat[..., -1] - flat[..., -2] <= GAP * np.abs(flat[..., -1])))


def _agg(mode, x, yd, yv, r, **kw):
    fn = getattr(local_agg, f"local_{mode}_aggregate")
    return fn(to_nchw(x), to_nchw(yd), to_nchw(yv), r, **kw)


@pytest.mark.parametrize("shape,valid,r", [((8, 16), (6, 9), 2),
                                           ((11, 40), (7, 33), 3),
                                           ((8, 16), (8, 11), 4)])
@pytest.mark.parametrize("mode", MODES)
def test_plain_b5_valid_matches_jax(mode, shape, valid, r):
    """The band of every input holds noise: the port ignores it, and JAX
    is given y_val's band zero, as its masked model re-zeroes it."""
    h, w = shape
    hv, wv = valid
    x, yd, yv = local_agg_inputs(np.random.default_rng(hv * wv + r), 1, h,
                                 w, 16, 24)
    yv_j = np.asarray(jmasked.mask_valid(jnp.asarray(yv), valid))
    dist = jlp.local_pairwise_dist(jnp.asarray(x), jnp.asarray(yd), r,
                                   valid_hw=valid)
    want = np.asarray(jax_warp_one_scale(
        dist, jnp.asarray(yv_j), r, mode == "softmax", mode == "nearest",
        3.0, 24))[:, :hv, :wv]
    got = to_nhwc(_agg(mode, x, yd, yv, r, valid_hw=valid))
    np.testing.assert_array_equal(got[:, hv:], 0.0)
    np.testing.assert_array_equal(got[:, :, wv:], 0.0)
    got = got[:, :hv, :wv]
    if mode == "nearest":
        keep = ~_near_ties(dist)[:, :hv, :wv]
        np.testing.assert_array_equal(got[keep], want[keep])
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_plain_b5_padded_matches_crop(mode):
    h, w, hv, wv, r = 8, 16, 6, 9, 2
    x, yd, yv = local_agg_inputs(np.random.default_rng(4), 2, h, w, 12, 20)
    got = _agg(mode, x, yd, yv, r, valid_hw=(hv, wv))
    crop = [np.ascontiguousarray(a[:, :hv, :wv]) for a in (x, yd, yv)]
    want = _agg(mode, *crop, r)
    np.testing.assert_allclose(got[..., :hv, :wv].numpy(), want.numpy(),
                               atol=1e-6, rtol=0)
    assert torch.equal(_agg(mode, x, yd, yv, r, valid_hw=(h, w)),
                       _agg(mode, x, yd, yv, r))


@pytest.mark.parametrize("valid", [(9, 9), (8, 17), (0, 9), (6, 0)])
def test_b5_refuses_a_valid_size_outside_the_grid(valid):
    x, yd, yv = local_agg_inputs(np.random.default_rng(5), 1, 8, 16, 4, 4)
    for mode in MODES:
        fn = getattr(local_agg, f"local_{mode}_aggregate")
        before = fn.launches
        with pytest.raises(ValueError, match="outside the"):
            _agg(mode, x, yd, yv, 2, valid_hw=valid)
        assert fn.launches == before


# (b) the bucketed models

def _jax_args(**kw):
    ns = argparse.Namespace(
        num_class=K, method="our_warp", clip_num=4, dilation_num=0,
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


# (port method, JAX-side options, port CLI flags, importer)
RUNS = {
    "our_warp": ({}, [], import_clip_warp_state_dict),
    "our_warp_softmax": ({"distsoftmax": True}, ["--distsoftmax", "true"],
                         import_clip_warp_state_dict),
    "our_warp_nearest": ({"distnearest": True}, ["--distnearest", "true"],
                         import_clip_warp_state_dict),
    "ETC": ({"method": "ETC", "clip_num": 2}, ["--clip_num", "2"],
            import_etc_state_dict),
}


def _models(run):
    """(JAX cfg, JAX args, JAX model, variables, port model): the port's
    seeded init, BatchNorm perturbed, and its weights in JAX."""
    opts, _, importer = RUNS[run]
    cfg, pcfg = _cfgs()
    args = _jax_args(**opts)
    jmodel, _ = jax_build(args.method, cfg, args)
    port, _ = build_method(args.method, pcfg, args)
    init_weights(port, torch.Generator().manual_seed(0))
    perturb_port_batchnorm(port, 1)
    return cfg, args, jmodel, importer(port.state_dict()), port.eval()


def _window(seed, t1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(t1, 1, H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("run", list(RUNS))
def test_bucketed_window_model_matches_jax_and_exact(run):
    _, args, jmodel, variables, port = _models(run)
    imgs = _window(3, args.clip_num)
    padded = np.zeros(imgs.shape[:2] + PAD + (3,), np.float32)
    padded[:, :, :H, :W] = imgs
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, x: jmodel.apply(
            v, x, train=False, valid_hw=(H, W))[0])(
                variables, jnp.asarray(padded)))
    nchw = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(padded, -1, 2)))
    with torch.inference_mode():
        got = port(nchw, valid_hw=(H, W))[0]
        exact = port(to_nchw(imgs))[0]
    hv, wv = masked.feature_valid(*got.shape[-2:], (H, W), PAD)
    assert (hv, wv) == (6, 9) == tuple(exact.shape[-2:])
    got = to_nhwc(got)[:, :hv, :wv]
    want = want[:, :hv, :wv]
    scale = want.max() - want.min()
    assert np.abs(got - want).max() <= 1e-4 * scale
    assert np.abs(got - to_nhwc(exact)).max() <= 1e-4 * scale


# (c) the CLI, default bucket

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("window_bucketed") / "vspw")
    make_synthetic_vspw(root, 1, 10, (H, W), K, seed=7)
    return root


def assert_same_pngs(pdir, jdir):
    names = sorted(os.listdir(jdir))
    assert len(names) == 10 and sorted(os.listdir(pdir)) == names
    for n in names:
        a, b = Image.open(os.path.join(jdir, n)), Image.open(
            os.path.join(pdir, n))
        assert b.mode == "P" and a.getpalette() == b.getpalette()
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("run", ["our_warp", "our_warp_nearest", "ETC"])
def test_bucketed_window_cli_matches_jax(root, tmp_path, run):
    cfg, args, _, variables, port = _models(run)
    _, flags, _ = RUNS[run]
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
        "--method", args.method, "--max_distances", "2", *flags, "--load",
        ckpt, "--is_save", "--saveroot", str(tmp_path / "port"),
        "--device", "cpu"])
    assert_same_pngs(str(tmp_path / "port" / "video_000"),
                     str(tmp_path / "jax" / "video_000"))
    assert pm["mIoU"] == pytest.approx(jm["mIoU"], abs=1e-12)
    assert pm["VC"] == pytest.approx(jm["VC"], abs=1e-12)

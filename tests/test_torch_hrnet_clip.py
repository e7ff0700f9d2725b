"""HRNetV2-clip (``hrnetv2_clip``: models/hrnet_clip.py) of the port
against the JAX package, f32 on the CPU.

W48's widths are fixed, so the frames are small: windows of 2 context
frames and the target, 40x53, in the 64x64 bucket.  The frames of a window
differ in scale and offset, so that TimeAtten's cosine softmax over them is
far from uniform.  Weights: a seeded port init, BatchNorm calibrated on a
window (``torch_port_util.calibrate_batchnorm``), read into Flax variables
through ``import_hrnet_clip_state_dict`` and ``import_decoder_by_arch``.

(a) ``TimeAtten`` at exact shapes and with a valid size, its inputs' bands
    holding garbage: the port pools the valid region only;
(b) ``SegmentationModuleClip`` logits within 1e-4, exact, and bucketed
    against the port's exact run and JAX's exact run; the planted fault
    (TimeAtten pooling the padded grid, band and all) moves them 1000-fold
    past that limit.  JAX's own bucketed model does just that (its pooling
    sums the stem's band, which its masks leave unzeroed): here it reads
    0.148 from its exact run at a largest logit of 14.3, so the port's
    bucketed runs are held against JAX's exact ones;
(c) training mode: tests/test_torch_hrnet_clip_train.py;
(d) the weights both ways, exactly;
(e) ``test_clip --method hrnetv2_clip`` against the JAX CLI, exact and
    bucketed: identical PNGs, equal mIoU and VC;
(f) ``build_method`` gives the model and ``seg_clip_loss``; ``train_clip``
    does not offer the method, as JAX's trainer does not.
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
from cvpr2021_vspw_implement_tpu.models import hrnet_clip as jhc
from cvpr2021_vspw_implement_tpu.models.import_torch import (
    import_decoder_by_arch, import_hrnet_clip_state_dict)
from cvpr2021_vspw_implement_tpu.test_clip import evaluate_clip
from cvpr2021_vspw_implement_tpu_torch import methods, test_clip
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.config.args import \
    build_train_clip_parser
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.data import make_synthetic_vspw
from cvpr2021_vspw_implement_tpu_torch.models import hrnet_clip
from cvpr2021_vspw_implement_tpu_torch.models.layers import init_weights
from cvpr2021_vspw_implement_tpu_torch.ops import masked
from torch_port_util import (assert_trees_equal, calibrate_batchnorm,
                             numpy_tree, to_nchw, to_nhwc)

K, T = 5, 3
HW, VALID = (64, 64), (40, 53)
PRESET = os.path.join(os.path.dirname(test_clip.__file__), "config",
                      "presets", "vsp-hrnetv2_clip.yaml")


def _close(got, want, what="", rel=1e-5):
    tol = max(1e-4, rel * float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max |diff| {err:.3e} above {tol:.3e}"
    return err


def _args(**kw):
    ns = argparse.Namespace(num_class=K, method="hrnetv2_clip", clip_num=T,
                            dilation_num=0, dilation2="1,2",
                            deepsup_scale=0.4)
    for key, v in kw.items():
        setattr(ns, key, v)
    return ns


def _pcfg():
    cfg = port_default_cfg.clone()
    cfg.merge_from_file(PRESET)
    return cfg


def _window(seed, n=2, hw=VALID):
    """[T, n, H, W, 3]: frame t scaled by 1 + t and shifted by t / 2."""
    x = np.random.default_rng(seed).standard_normal(
        (T, n, *hw, 3)).astype(np.float32)
    return x * (1 + np.arange(T))[:, None, None, None, None] \
        + 0.5 * np.arange(T)[:, None, None, None, None]


def _nchw(x):
    return to_nchw(x)            # [T, B, 3, H, W]


def _variables(port):
    enc = import_hrnet_clip_state_dict(port.encoder.state_dict())
    dec = import_decoder_by_arch("c1", port.decoder.state_dict())
    return numpy_tree({c: {"encoder": enc[c], "decoder": dec[c]}
                       for c in ("params", "batch_stats")})


@pytest.fixture(scope="module")
def weights():
    """(JAX model, variables, port model carried from them, the window the
    BatchNorm statistics were calibrated on)."""
    jmodel, _ = jax_build("hrnetv2_clip", _jax_cfg(), _args(), None)
    src, _ = methods.build_method("hrnetv2_clip", _pcfg(), _args())
    init_weights(src, torch.Generator().manual_seed(0))
    win = _window(1)
    calibrate_batchnorm(src, _nchw(win))
    variables = _variables(src)
    port, _ = methods.build_method("hrnetv2_clip", _pcfg(), _args())
    return jmodel, variables, load_jax_variables(port, variables).eval(), win


@pytest.fixture(scope="module")
def models(weights):
    """``weights`` and the window's padded copy and JAX's exact logits."""
    jmodel, variables, port, win = weights
    pad = np.zeros((T, 2, *HW, 3), np.float32)
    pad[:, :, :VALID[0], :VALID[1]] = win
    with jax.default_matmul_precision("highest"):
        exact = jax.jit(lambda v, x: jmodel.apply(v, x[-1], x[:-1],
                                                  train=False))(
            variables, jnp.asarray(win))[0]
    return jmodel, variables, port, win, pad, np.asarray(exact)


@pytest.mark.parametrize("valid", [False, True])
def test_time_atten_matches_jax(models, valid):
    """TimeAtten's output: exact shapes, and with the valid size 10x14 of a
    16x16 grid whose band holds garbage in the port's inputs and zeros in
    JAX's (JAX's pooling sums the whole grid, JAX hrnet_clip.py:44-49:
    given the band the port is given, it would count it)."""
    _, variables, port, *_ = models
    rng = np.random.default_rng(3)
    c = rng.standard_normal((2, 16, 16, 256)).astype(np.float32)
    clips = (rng.standard_normal((T - 1, 2, 16, 16, 256))
             + np.arange(1, T)[:, None, None, None, None]).astype(np.float32)
    fv = (10, 14) if valid else None
    jc, jclips = c.copy(), clips.copy()
    if valid:
        jc[..., 10:, :, :] = 0
        jc[..., 14:, :] = 0
        jclips[..., 10:, :, :] = 0
        jclips[..., 14:, :] = 0
    node = {"params": variables["params"]["encoder"]["time_atten"]}
    with jax.default_matmul_precision("highest"):
        want = jhc.TimeAtten(256).apply(node, jnp.asarray(jc),
                                        jnp.asarray(jclips), feat_valid=fv)
    with torch.inference_mode():
        got = port.encoder.time_atten(to_nchw(c), to_nchw(clips), fv)
    h, w = fv or (16, 16)
    _close(to_nhwc(got)[:, :h, :w], np.asarray(want)[:, :h, :w])


def test_hrnet_clip_logits_match_jax(models):
    _, _, port, win, _, want = models
    with torch.inference_mode():
        got = port(_nchw(win))[0]
    assert tuple(got.shape) == (2, K, 10, 14)
    _close(to_nhwc(got), want, "exact")


def test_hrnet_clip_bucketed_matches_exact(models, monkeypatch):
    """The window padded to 64x64 with the true size 40x53: the valid
    region is the exact run's (JAX's exact logits, the port's too).  The
    planted fault, TimeAtten pooling the padded grid with its band
    unzeroed, moves them past the limit."""
    jmodel, variables, port, win, pad, want = models
    with torch.inference_mode():
        got = port(_nchw(pad), valid_hw=VALID)[0]
        exact = port(_nchw(win))[0]
    hv, wv = masked.feature_valid(*got.shape[-2:], VALID, HW)
    _close(to_nhwc(got)[:, :hv, :wv], want, "bucketed vs JAX exact")
    _close(got[..., :hv, :wv].numpy(), exact.numpy(), "bucketed vs exact")
    monkeypatch.setattr(hrnet_clip, "pool_valid",
                        lambda v, _: v.float().mean(dim=(2, 3)))
    with torch.inference_mode():
        bad = port(_nchw(pad), valid_hw=VALID)[0]
    err = float(np.abs(to_nhwc(bad)[:, :hv, :wv] - want).max())
    tol = max(1e-4, 1e-5 * float(np.abs(want).max()))
    print(f"\nhrnetv2_clip bucketed with TimeAtten's planted fault: "
          f"{err:.3e} from exact (limit {tol:.3e}; largest logit "
          f"{np.abs(want).max():.2f})")
    assert err > 100 * tol


def _jax_cfg():
    cfg = jax_default_cfg.clone()
    cfg.MODEL.arch_encoder, cfg.MODEL.arch_decoder = "hrnetv2_clip", "c1"
    cfg.MODEL.fc_dim = 720
    cfg.TPU.compute_dtype = "float32"
    return cfg


def test_hrnet_clip_weights_round_trip(models):
    """The port's state_dict through the JAX importers is the tree it was
    loaded from, shaped as JAX's own init."""
    jmodel, variables, port, *_ = models
    assert_trees_equal(_variables(port), variables)
    s = jnp.zeros((T, 1, 32, 32, 3))
    shapes = jax.tree_util.tree_map(lambda a: a.shape, jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), s[-1], s[:-1])))
    assert jax.tree_util.tree_map(lambda a: a.shape, variables) == shapes


def test_seg_clip_loss_matches_jax():
    rng = np.random.default_rng(4)
    out = rng.normal(size=(2, 6, 7, K)).astype(np.float32)
    lab = rng.integers(0, K, (T, 2, 24, 28)).astype(np.int32)
    lab[-1, :, :3, :5] = 255
    wl, wa = jhc.seg_clip_loss((jnp.asarray(out),),
                               {"labels": jnp.asarray(lab)})
    gl, ga = hrnet_clip.seg_clip_loss(
        (to_nchw(out),), {"labels": torch.from_numpy(lab).long()})
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-5)
    np.testing.assert_allclose(float(ga), float(wa), atol=1e-6)


def test_method_registry_and_trainer_choices():
    model, loss = methods.build_method("hrnetv2_clip", _pcfg(), _args())
    assert isinstance(model, hrnet_clip.SegmentationModuleClip)
    assert isinstance(model.encoder, hrnet_clip.HRNetV2Clip)
    assert model.encoder.clip_middle and loss is hrnet_clip.seg_clip_loss
    assert not methods.build_method("hrnetv2_clip", _pcfg(), _args(
        clip_middle=False))[0].encoder.clip_middle
    assert "hrnetv2_clip" in test_clip.EVAL_METHODS
    with pytest.raises(SystemExit):
        build_train_clip_parser().parse_args(
            ["--cfg", PRESET, "--method", "hrnetv2_clip"])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vspw_hrnet_clip")
    make_synthetic_vspw(str(root), num_videos=1, frames_per_video=6,
                        size=VALID, num_class=K, seed=17)
    return str(root)


@pytest.fixture(scope="module")
def jax_cli(models, root, tmp_path_factory):
    """(metrics, PNG directory) of the JAX CLI at exact shapes, once: its
    bucketed TimeAtten counts the stem's band (see (a)), so the port's
    runs, exact and bucketed, are both held against this one."""
    _, variables, *_ = models
    out = tmp_path_factory.mktemp("jax_cli")
    jargs = argparse.Namespace(
        dataroot=root, split="val", num_class=K, method="hrnetv2_clip",
        clip_num=T, dilation_num=0, dilation2="1,2", vc_clip_num=4,
        lesslabel=False, use_memory=False, memory_num=8, clipocr_all=False,
        psp_weight=False, deepsup_scale=0.4, load="", is_save=True,
        saveroot=str(out), streaming=False, width_bucket=0)
    with jax.default_matmul_precision("highest"):
        jm, _ = evaluate_clip(_jax_cfg(), jargs, variables=variables,
                              is_save=True)
    return jm, out / "video_000"


@pytest.mark.parametrize("bucket", [0, 64])
def test_cli_matches_jax(models, root, jax_cli, tmp_path, bucket):
    """``test_clip --method hrnetv2_clip --clip_num 3`` against the JAX CLI
    on the same weights, exact and bucketed."""
    _, _, port, *_ = models
    jm, jdir = jax_cli
    ckpt = str(tmp_path / "model.pth")
    torch.save(port.state_dict(), ckpt)
    pm, _ = test_clip.main([
        "--cfg", PRESET, "--dataroot", root, "--num_class", str(K),
        "--method", "hrnetv2_clip", "--clip_num", str(T), "--vc_clip_num",
        "4", "--width_bucket", str(bucket), "--load", ckpt, "--is_save",
        "--saveroot", str(tmp_path / "port"), "--device", "cpu"])
    pdir = tmp_path / "port" / "video_000"
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names and len(names) == 6
    classes = set()
    for name in names:
        a = np.asarray(Image.open(jdir / name))
        np.testing.assert_array_equal(np.asarray(Image.open(pdir / name)), a,
                                      err_msg=name)
        classes |= set(np.unique(a).tolist())
    assert len(classes) > 1, "the predictions hold one class"
    assert pm["mIoU"] == jm["mIoU"] and pm["VC"] == jm["VC"]

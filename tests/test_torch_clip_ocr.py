"""TCB-OCR (``clip_ocr``) of the port against the JAX package, f32 on the
CPU.

ResNet-18-dilated, fc_dim 512, 5 classes.  Weights are a seeded port init
with BatchNorm statistics perturbed, carried to JAX through its importers
(``import_ocr_decoder_state_dict``, ``import_clip_ocr_state_dict``);
inputs come from numpy with a seed.

(a) ``spatial_gather`` (with and without ``valid``; atol 1e-5),
    ``ObjectAttentionBlock2D`` and ``SpatialOCR`` (1e-5 of the largest
    value) against JAX;
(b) ``ClipOCRNet`` logits in eval and in training mode (main and DSN),
    and ``clip_ocr_loss``, against JAX (logits within 1e-4, loss rtol
    1e-4: the port's loss is the projected form), with and without
    ``clipocr_all``; the streaming memory against JAX's over several
    windows;
(c) the streaming building blocks (``encode_frame``, the mean of the
    contexts, ``fuse_target``) equal to the window forward, and the
    bucketed ``encode_frame`` equal to the exact one on the valid region;
(d) ``test_clip --method clip_ocr`` streaming, ``--use_memory`` and
    ``--clipocr_all`` against the JAX CLI on a 10-frame 48x72 video (the
    64x128 bucket has a band in both axes): identical PNGs, equal mIoU and
    VC, exact and bucketed.  JAX's side runs once a route, bucketed (its
    default; tests/test_masked_eval.py holds JAX's bucketed PNGs equal to
    its exact ones).
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
from cvpr2021_vspw_implement_tpu.models import layers as jlayers
from cvpr2021_vspw_implement_tpu.models import ocr as jocr
from cvpr2021_vspw_implement_tpu.models.clip_ocr import \
    clip_ocr_loss as jax_clip_ocr_loss
from cvpr2021_vspw_implement_tpu.models.clip_ocr import \
    init_memory as jax_init_memory
from cvpr2021_vspw_implement_tpu.models.import_torch import (
    import_clip_ocr_state_dict, import_ocr_decoder_state_dict)
from cvpr2021_vspw_implement_tpu.test_clip import evaluate_clip
from cvpr2021_vspw_implement_tpu_torch import test_clip
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.data import (TestLongClipDataset,
                                                    make_synthetic_vspw)
from cvpr2021_vspw_implement_tpu_torch.methods import build_method
from cvpr2021_vspw_implement_tpu_torch.models import layers
from cvpr2021_vspw_implement_tpu_torch.models import ocr
from cvpr2021_vspw_implement_tpu_torch.models.clip_ocr import (clip_ocr_loss,
                                                               init_memory)
from cvpr2021_vspw_implement_tpu_torch.ops import masked
from cvpr2021_vspw_implement_tpu_torch.serving import ClipOCRStreamer
from torch_port_util import perturb_port_batchnorm, to_nchw, to_nhwc

K, H, W = 5, 48, 72
PRESET = os.path.join(os.path.dirname(__file__), os.pardir,
                      "cvpr2021_vspw_implement_tpu_torch", "config", "presets",
                      "vsp-resnet18dilated-ppm_deepsup_clip.yaml")


@pytest.fixture()
def no_dropout():
    jlayers.set_dropout_override(0.0)
    layers.set_dropout_override(0.0)
    yield
    jlayers.set_dropout_override(None)
    layers.set_dropout_override(None)


def _highest(fn, *args):
    with jax.default_matmul_precision("highest"):
        return fn(*args)


# (a) the OCR blocks

@pytest.mark.parametrize("valid", [None, (6, 9), (8, 5)])
def test_spatial_gather_matches_jax(valid):
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 8, 16, 24)).astype(np.float32)
    probs = (3 * rng.normal(size=(2, 8, 16, K))).astype(np.float32)
    if valid is not None:   # the band holds noise: only the logits mask it
        feats[:, valid[0]:] = 0
        feats[:, :, valid[1]:] = 0
    want = np.asarray(_highest(jocr.spatial_gather, jnp.asarray(feats),
                               jnp.asarray(probs), 1.0, valid))
    got = ocr.spatial_gather(to_nchw(feats), to_nchw(probs), valid=valid)
    assert got.shape == (2, 24, K, 1)
    np.testing.assert_allclose(got[..., 0].transpose(1, 2).numpy(), want,
                               atol=1e-5, rtol=0)
    if valid is not None:   # equal to the gather over the crop
        hv, wv = valid
        crop = ocr.spatial_gather(to_nchw(feats[:, :hv, :wv]),
                                  to_nchw(probs[:, :hv, :wv]))
        torch.testing.assert_close(got, crop, atol=1e-6, rtol=0)


def _ocr_vars(port_module, prefix):
    sd = {prefix + k: v for k, v in port_module.state_dict().items()}
    out = import_ocr_decoder_state_dict(sd)
    path = prefix.rstrip(".").split(".")
    params, stats = out["params"], out["batch_stats"]
    for p in path:
        params, stats = params[p], stats[p]
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("block", ["attention", "spatial_ocr"])
def test_ocr_blocks_match_jax(block):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 8, 512)).astype(np.float32)
    proxy = rng.normal(size=(2, K, 512)).astype(np.float32)
    if block == "attention":
        port = ocr.ObjectAttentionBlock2D(512, 256)
        jmod = jocr.ObjectAttentionBlock2D(512, 256)
        prefix = "spatial_ocr_head.object_context_block."
    else:
        port = ocr.SpatialOCR(512, 256, 512, dropout=0.05)
        jmod = jocr.SpatialOCR(512, 256, 512, dropout=0.05)
        prefix = "spatial_ocr_head."
    layers.init_weights(port, torch.Generator().manual_seed(2))
    perturb_port_batchnorm(port, 3)
    variables = _ocr_vars(port, prefix)
    want = np.asarray(_highest(lambda: jmod.apply(
        variables, jnp.asarray(x), jnp.asarray(proxy), False)))
    with torch.no_grad():
        got = port.eval()(to_nchw(x), torch.from_numpy(
            proxy.transpose(0, 2, 1)[..., None].copy()))
    # 1x1 convs over 512 channels after perturbed BatchNorms: f32 sums in
    # another order, 1e-5 of the largest value
    np.testing.assert_allclose(to_nhwc(got), want,
                               atol=1e-5 * np.abs(want).max(), rtol=0)


# (b) the model

def _jax_args(**kw):
    ns = argparse.Namespace(
        num_class=K, method="clip_ocr", clip_num=4, dilation_num=0,
        dilation2="3,6,9", deepsup_scale=0.4, st_weight=0.1, allsup=False,
        allsup_scale=0.3, linear_combine=False, distsoftmax=False,
        distnearest=False, temp=3.0, max_distances=[2], fix=False,
        psp_weight=False, use_memory=False, memory_num=8, clipocr_all=False)
    for key, v in kw.items():
        setattr(ns, key, v)
    return ns


def _models(**kw):
    """(JAX cfg, JAX args, JAX model, variables, port model): the port's
    seeded init, BatchNorm perturbed, and its weights in JAX."""
    cfg = jax_default_cfg.clone()
    cfg.MODEL.arch_encoder = "resnet18dilated"
    cfg.MODEL.fc_dim = 512
    cfg.TPU.compute_dtype = "float32"
    pcfg = port_default_cfg.clone()
    pcfg.merge_from_file(PRESET)
    args = _jax_args(**kw)
    jmodel, _ = jax_build("clip_ocr", cfg, args)
    port, _ = build_method("clip_ocr", pcfg, args)
    layers.init_weights(port, torch.Generator().manual_seed(0))
    perturb_port_batchnorm(port, 1)
    # the classifier's bias evens out the classes' mean logits on a random
    # clip: else one class wins every pixel and a PNG comparison says little
    with torch.no_grad():
        (logits,) = port.eval()(_nchw_clip(_clip(0)))
        port.head.bias.sub_(logits.mean((0, 2, 3)))
    return (cfg, args, jmodel, import_clip_ocr_state_dict(port.state_dict()),
            port)


def _clip(seed, t1=4, b=1, h=H, w=W):
    return np.random.default_rng(seed).normal(
        size=(t1, b, h, w, 3)).astype(np.float32)


def _nchw_clip(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 2)))


def _close(got, want, bar=1e-4):
    assert np.abs(got - want).max() <= bar * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("clipocr_all", [False, True])
def test_clip_ocr_eval_logits_match_jax(clipocr_all):
    _, _, jmodel, variables, port = _models(clipocr_all=clipocr_all)
    x = _clip(4)
    want = np.asarray(_highest(lambda: jmodel.apply(
        variables, jnp.asarray(x), train=False)[0]))
    with torch.no_grad():
        (got,) = port.eval()(_nchw_clip(x))
    _close(to_nhwc(got), want)


@pytest.mark.parametrize("clipocr_all", [False, True])
def test_clip_ocr_train_logits_and_loss_match_jax(no_dropout, clipocr_all):
    _, _, jmodel, variables, port = _models(clipocr_all=clipocr_all)
    x = _clip(5, b=2, h=40, w=40)
    rng = np.random.default_rng(6)
    labels = rng.integers(0, K, (4, 2, 40, 40)).astype(np.int32)
    labels[:, :, 0, :4] = 255
    key = jax.random.PRNGKey(0)
    (jmain, jdsn), _ = _highest(lambda: jmodel.apply(
        variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
        rngs={"dropout": key}))
    jloss, jacc = jax_clip_ocr_loss((jmain, jdsn),
                                    {"labels": jnp.asarray(labels)},
                                    clipocr_all=clipocr_all)
    main, dsn = port.train()(_nchw_clip(x))
    _close(to_nhwc(main.detach()), np.asarray(jmain))
    _close(to_nhwc(dsn.detach()), np.asarray(jdsn))
    loss, acc = clip_ocr_loss((main, dsn), {"labels": torch.from_numpy(
        labels).long()}, clipocr_all=clipocr_all)
    assert loss.item() == pytest.approx(float(jloss), rel=1e-4)
    assert acc.item() == pytest.approx(float(jacc), abs=1e-3)


def test_clip_ocr_memory_matches_jax():
    """Three windows through the ring of memory_num 2 (3 entries): the
    first fills it partly, the later ones roll it."""
    _, _, jmodel, variables, port = _models()
    jmem = jax_init_memory(2, 1, K)
    mem = init_memory(2, 1, K)
    apply = jax.jit(lambda v, x, m: jmodel.apply(v, x, train=False,
                                                 memory=m))
    for seed in (7, 8, 9):
        x = _clip(seed, t1=2)
        with jax.default_matmul_precision("highest"):
            (want,), jmem = apply(variables, jnp.asarray(x), jmem)
        with torch.no_grad():
            (got,), mem = port.eval()(_nchw_clip(x), memory=mem)
        _close(to_nhwc(got), np.asarray(want))
        assert mem[1] == int(jmem[1])
        _close(mem[0][..., 0].transpose(2, 3).numpy(), np.asarray(jmem[0]))


# (c) streaming against the window forward; bucketed encode against exact

def test_streaming_blocks_equal_the_window_forward():
    _, _, _, _, port = _models()
    port.eval()
    x = _clip(10, t1=6)
    frames = [_nchw_clip(x[i:i + 1])[0] for i in range(6)]
    with torch.no_grad():
        cache = [port.encode_frame(f) for f in frames]
        streamer = ClipOCRStreamer(port, [1, 2, 3], 6, (H, W), device="cpu")
        for i in range(6):
            idxs = [i] + streamer.context_indices(i)
            stream = port.fuse_target(
                cache[i][0], streamer._blend({k: cache[k][1] for k in idxs},
                                             idxs))
            window = torch.stack([frames[k] for k in idxs[1:] + [i]])
            (want,) = port(window)
            # the window encodes 4 frames in one batch, the streamer one:
            # f32 sums in another order
            _close(stream.numpy(), want.numpy())


def test_bucketed_encode_matches_exact():
    _, _, _, _, port = _models()
    port.eval()
    x = _clip(11, t1=1)
    padded = np.zeros((1, 1, 64, 128, 3), np.float32)
    padded[:, :, :H, :W] = x
    with torch.inference_mode():
        feat, ctx = port.encode_frame(_nchw_clip(x)[0])
        feat_b, ctx_b = port.encode_frame(_nchw_clip(padded)[0],
                                          valid_hw=(H, W))
    fv = masked.feature_valid(*feat_b.shape[-2:], (H, W), (64, 128))
    assert fv == tuple(feat.shape[-2:]) == (6, 9)
    assert not feat_b[..., fv[0]:, :].any() and not feat_b[..., fv[1]:].any()
    _close(feat_b[..., :6, :9].numpy(), feat.numpy())
    _close(ctx_b.numpy(), ctx.numpy())


# (d) the CLI

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("clip_ocr") / "vspw")
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


#: route → (JAX options, port flags)
ROUTES = {
    "streaming": ({}, []),
    "use_memory": ({"use_memory": True}, ["--use_memory", "true"]),
    "clipocr_all": ({"clipocr_all": True}, ["--clipocr_all", "true"]),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_clip_ocr_cli_matches_jax(root, tmp_path, route):
    opts, flags = ROUTES[route]
    cfg, args, _, variables, port = _models(**opts)
    for key, v in dict(dataroot=root, split="val", vc_clip_num=8,
                       lesslabel=False, load="", is_save=True,
                       saveroot=str(tmp_path / "jax"),
                       width_bucket=64).items():
        setattr(args, key, v)
    with jax.default_matmul_precision("highest"):
        jm, _ = evaluate_clip(cfg, args, variables=variables, is_save=True)
    ckpt = str(tmp_path / "model.pth")
    torch.save(port.state_dict(), ckpt)
    for name, extra in (("exact", ["--width_bucket", "0", "--eval_policy",
                                   "exact"]), ("bucketed", [])):
        pm, _ = test_clip.main([
            "--cfg", PRESET, "--dataroot", root, "--num_class", str(K),
            "--method", "clip_ocr", *flags, *extra, "--load", ckpt,
            "--is_save", "--saveroot", str(tmp_path / name), "--device",
            "cpu"])
        assert_same_pngs(str(tmp_path / name / "video_000"),
                         str(tmp_path / "jax" / "video_000"))
        assert pm["mIoU"] == pytest.approx(jm["mIoU"], abs=1e-12)
        assert pm["VC"] == pytest.approx(jm["VC"], abs=1e-12)
        if route == "streaming":
            assert pm["buckets"] == ([(64, 128)] if name == "bucketed"
                                     else [])


def test_test_long_clip_dataset_matches_jax(root):
    from cvpr2021_vspw_implement_tpu.data import \
        TestLongClipDataset as JaxTestLongClipDataset
    args = argparse.Namespace(clip_num=4, dilation2="3,6,9", lesslabel=False)
    mine = TestLongClipDataset(root, "video_000", args)
    ref = JaxTestLongClipDataset(root, "video_000", args)
    assert len(mine) == len(ref) == 10
    for i in (0, 5, 9):
        got, want = mine[i], ref[i]
        assert got[4] == want[4] and len(got[2]) == len(want[2]) == 3
        for g, w in zip([got[0], *got[2], *got[3]],
                        [want[0], *want[2], *want[3]]):
            np.testing.assert_array_equal(g, w)

"""The per-frame path of the port against the JAX package: the decoders,
``SegmentationModule`` (exact and width-bucketed), its loss and inference
heads, and the per-frame eval CLI ``test``.

ResNet-18-dilated, fc_dim 512, 5 classes, small frames, f32 on the CPU.
Weights: a seeded port init read into Flax variables through the JAX
importers (``import_resnet_state_dict``, ``import_decoder_by_arch``), its
BatchNorm statistics perturbed, and carried back by ``convert.py``, so the
importers' naming is held too.  Bars: logits within 1e-4 at a trained
model's logit scale, 10: within 1e-5 of the largest logit (and 1e-4 at
least), since a deep conv stack sums in another order on each side and
these random-init logits reach 57-180, where f32 rounding alone puts both
sides 4e-5-1.3e-4 from a float64 run of the port.  In training mode
BatchNorm normalises by batch statistics, whose variance JAX takes in one
pass (E[x^2] - E[x]^2) and torch in two: the JAX outputs sit 3-4x further
from float64 than the port's (7.4e-4 against 1.7e-4 at a largest logit of
32), so there the port is held within 1e-5 of the largest logit of its own
float64 run and within 4e-5 of JAX.  The loss and accuracy within 1e-5,
PNGs identical and metrics equal.
"""

import argparse
import copy
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cvpr2021_vspw_implement_tpu import test as jax_test
from cvpr2021_vspw_implement_tpu.config import cfg as jax_default_cfg
from cvpr2021_vspw_implement_tpu.models import segmentation as jseg
from cvpr2021_vspw_implement_tpu.models.builder import \
    ModelBuilder as JaxModelBuilder
from cvpr2021_vspw_implement_tpu.models.import_torch import (
    import_decoder_by_arch, import_resnet_state_dict)
from cvpr2021_vspw_implement_tpu.ops import masked as jmasked
from cvpr2021_vspw_implement_tpu_torch import test as port_test
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.data import make_synthetic_vspw
from cvpr2021_vspw_implement_tpu_torch.models import segmentation
from cvpr2021_vspw_implement_tpu_torch.models.builder import ModelBuilder
from cvpr2021_vspw_implement_tpu_torch.models.layers import init_weights
from cvpr2021_vspw_implement_tpu_torch.ops import masked
from torch_port_util import perturb_batchnorm, to_nchw, to_nhwc

K = 5
DECODERS = ("c1", "c1_deepsup", "ppm", "ppm_deepsup")
PRESET = os.path.join(os.path.dirname(port_test.__file__), "config",
                      "presets", "vsp-resnet18dilated-ppm_deepsup.yaml")


def _variables(port, arch_decoder, seed):
    """Flax variables of ``port``'s weights through the JAX importers, BN
    statistics perturbed."""
    enc = import_resnet_state_dict(port.encoder.state_dict())
    dec = import_decoder_by_arch(arch_decoder, port.decoder.state_dict())
    return perturb_batchnorm(
        {c: {"encoder": enc[c], "decoder": dec[c]}
         for c in ("params", "batch_stats")}, seed)


@pytest.fixture(scope="module", params=DECODERS)
def frame_model(request):
    """(decoder arch, JAX model, variables, port model in eval mode)."""
    dec = request.param
    port = segmentation.SegmentationModule(
        ModelBuilder.build_encoder("resnet18dilated"),
        ModelBuilder.build_decoder(dec, fc_dim=512, num_class=K))
    init_weights(port, torch.Generator().manual_seed(DECODERS.index(dec)))
    variables = _variables(port, dec, seed=3)
    jmodel = jseg.SegmentationModule(
        JaxModelBuilder.build_encoder("resnet18dilated", fc_dim=512),
        JaxModelBuilder.build_decoder(dec, fc_dim=512, num_class=K))
    return dec, jmodel, variables, load_jax_variables(port, variables).eval()


def _close(got, want, what="", rel=1e-5):
    """|got - want| within ``rel`` of the largest |want|, and 1e-4 at
    least."""
    tol = max(1e-4, rel * float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max |diff| {err:.3e} above {tol:.3e}"


def _img(seed, h=40, w=56, n=2):
    return np.random.default_rng(seed).standard_normal(
        (n, h, w, 3)).astype(np.float32)


def test_frame_logits_match_jax(frame_model):
    """Eval logits at exact shapes, and in training mode (dropout off, a
    batch of 4) the main and deep-supervision logits."""
    dec, jmodel, variables, port = frame_model
    img = _img(1, n=4)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
            variables, jnp.asarray(img))
    with torch.inference_mode():
        got = port(to_nchw(img))
    assert len(got) == len(want) == 1
    _close(to_nhwc(got[0]), np.asarray(want[0]), f"{dec} eval")

    from cvpr2021_vspw_implement_tpu.models import layers as jlayers
    from cvpr2021_vspw_implement_tpu_torch.models import layers
    jlayers.set_dropout_override(0.0)
    layers.set_dropout_override(0.0)
    try:
        with jax.default_matmul_precision("highest"):
            want, _ = jmodel.apply(variables, jnp.asarray(img), train=True,
                                   mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(0)})
        # copies: a training-mode forward updates the running statistics
        train = copy.deepcopy(port).train()
        train64 = copy.deepcopy(train).double()
        with torch.no_grad():
            got = train(to_nchw(img))
            ref = train64(to_nchw(img).double())
    finally:
        jlayers.set_dropout_override(None)
        layers.set_dropout_override(None)
    assert len(got) == len(want) == (2 if "deepsup" in dec else 1)
    for i, (g, w, r) in enumerate(zip(got, want, ref)):
        _close(to_nhwc(g), to_nhwc(r), f"{dec} train output {i} vs float64")
        _close(to_nhwc(g), np.asarray(w), f"{dec} train output {i}", 4e-5)


def test_frame_masked_logits_match_jax_and_exact(frame_model):
    """With ``valid_hw``: the padded frame's logits on the valid region are
    the unpadded run's and JAX's masked module's."""
    _, jmodel, variables, port = frame_model
    img = _img(2, 40, 53, 1)
    pad_hw = masked.bucket_hw(40, 53)                   # (64, 64)
    imgp = np.asarray(jmasked.pad_to(jnp.asarray(img), pad_hw))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=False, valid_hw=(jnp.int32(40), jnp.int32(53))))(
                variables, jnp.asarray(imgp))[0]
    with torch.inference_mode():
        exact = port(to_nchw(img))[0]
        got = port(to_nchw(imgp), valid_hw=(40, 53))[0]
    hv, wv = masked.feature_valid(*got.shape[-2:], (40, 53), pad_hw)
    assert (hv, wv) == tuple(exact.shape[-2:])
    _close(got[..., :hv, :wv].numpy(), exact.numpy(), "padded vs exact")
    _close(to_nhwc(got)[:, :hv, :wv], np.asarray(want)[:, :hv, :wv],
           "padded vs JAX")


@pytest.mark.parametrize("deep_sup_scale", [0.4, None])
def test_segmentation_loss_and_pred_match_jax(deep_sup_scale):
    rng = np.random.default_rng(4)
    outs = [rng.normal(size=(2, 6, 7, K)).astype(np.float32)
            for _ in range(2)]
    label = rng.integers(0, K, (2, 48, 56)).astype(np.int32)
    label[:, :3, :5] = 255
    want_loss, want_acc = jseg.segmentation_loss(
        tuple(jnp.asarray(o) for o in outs), jnp.asarray(label),
        deep_sup_scale)
    got_loss, got_acc = segmentation.segmentation_loss(
        tuple(to_nchw(o) for o in outs), torch.from_numpy(label).long(),
        deep_sup_scale)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_acc.item(), float(want_acc), atol=1e-6)
    pred = segmentation.inference_pred(to_nchw(outs[0]), (48, 56))
    np.testing.assert_array_equal(
        pred.numpy(), np.asarray(jseg.inference_pred(
            (jnp.asarray(outs[0]),), (48, 56))))


@pytest.fixture(scope="module")
def vspw_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vspw_frame")
    make_synthetic_vspw(str(root), num_videos=2, frames_per_video=3,
                        size=(48, 70), num_class=K, seed=11)
    return str(root)


def _pngs(d):
    return {os.path.join(v, f): np.asarray(Image.open(os.path.join(d, v, f)))
            for v in sorted(os.listdir(d)) if v != "vmiou.pkl"
            for f in sorted(os.listdir(os.path.join(d, v)))}


def _jax_cfg(arch_decoder):
    cfg = jax_default_cfg.clone()
    cfg.merge_from_file(os.path.join(
        os.path.dirname(jax_test.__file__), "config", "presets",
        "vsp-resnet18dilated-ppm_deepsup.yaml"))
    cfg.MODEL.arch_decoder = arch_decoder
    cfg.TPU.compute_dtype = "float32"
    return cfg


@pytest.mark.parametrize("bucket", [0, 64])
def test_evaluate_matches_jax(vspw_root, tmp_path, bucket):
    """``test.evaluate`` against JAX ``test.evaluate`` on the same weights
    (``ppm_deepsup``): identical PNGs, equal metrics and ``vmiou.pkl``,
    exact (``--width_bucket 0``) and bucketed (48x70 in the 64x128
    bucket)."""
    port = segmentation.SegmentationModule(
        ModelBuilder.build_encoder("resnet18dilated"),
        ModelBuilder.build_decoder("ppm_deepsup", fc_dim=512, num_class=K))
    init_weights(port, torch.Generator().manual_seed(7))
    variables = _variables(port, "ppm_deepsup", seed=8)
    port = load_jax_variables(port, variables).eval()
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    args = port_test.build_eval_parser().parse_args(
        ["--cfg", PRESET, "--dataroot", vspw_root, "--num_class", str(K),
         "--width_bucket", str(bucket), "--saveroot", pdir, "--device",
         "cpu"])
    cfg = port_default_cfg.clone()
    cfg.merge_from_file(PRESET)
    got, got_v = port_test.evaluate(cfg, args, model=port, is_save=True)
    jargs = argparse.Namespace(**{**vars(args), "saveroot": jdir})
    with jax.default_matmul_precision("highest"):
        want, want_v = jax_test.evaluate(
            _jax_cfg("ppm_deepsup"), jargs,
            variables=jax.tree_util.tree_map(jnp.asarray, variables),
            is_save=True)
    for key in want:
        assert got[key] == want[key], key
    assert got_v == want_v
    assert got["buckets"] == ([(64, 128)] if bucket else [])
    a, b = _pngs(pdir), _pngs(jdir)
    assert sorted(a) == sorted(b) and len(a) == 6
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    with open(os.path.join(pdir, "vmiou.pkl"), "rb") as f:
        assert pickle.load(f) == want_v


def test_cli_loads_reference_checkpoints_strict(vspw_root, tmp_path):
    """``--load_en`` / ``--load_de``: reference-layout torch state_dicts
    loaded straight into the port (the JAX CLI reads the same files through
    its importers; identical PNGs); a checkpoint missing an entry is
    refused."""
    src = segmentation.SegmentationModule(
        ModelBuilder.build_encoder("resnet18dilated"),
        ModelBuilder.build_decoder("c1_deepsup", fc_dim=512, num_class=K))
    init_weights(src, torch.Generator().manual_seed(9))
    enc, dec = str(tmp_path / "enc.pth"), str(tmp_path / "dec.pth")
    torch.save({"module." + k: v for k, v in src.encoder.state_dict().items()},
               enc)
    torch.save(src.decoder.state_dict(), dec)
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    argv = ["--cfg", PRESET, "--dataroot", vspw_root, "--num_class", str(K),
            "--width_bucket", "0", "--load_en", enc, "--load_de", dec,
            "--seed", "3", "--is_save", "--saveroot", pdir, "--device", "cpu",
            "MODEL.arch_decoder", "c1_deepsup"]
    got, _ = port_test.main(argv)
    jargs = argparse.Namespace(
        dataroot=vspw_root, split="val", num_class=K, load="",
        torch_enc=enc, torch_dec=dec, saveroot=jdir, lesslabel=False,
        use_720p=False, width_bucket=0)
    with jax.default_matmul_precision("highest"):
        want, _ = jax_test.evaluate(_jax_cfg("c1_deepsup"), jargs,
                                    is_save=True)
    assert got["mIoU"] == want["mIoU"]
    a, b = _pngs(pdir), _pngs(jdir)
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)

    sd = src.decoder.state_dict()
    del sd["conv_last_deepsup_.bias"]
    torch.save(sd, dec)
    with pytest.raises(KeyError, match="conv_last_deepsup_.bias"):
        port_test.main(argv)

"""The remaining per-frame baselines of the port against the JAX package:
the ResNet trunk at output stride 32 and ResNeXt's grouped bottlenecks,
MobileNetV2-dilated, and the UPerNet, DeepLabV3+ and Non-local 2D heads;
exact and width-bucketed, the weights both ways, reference checkpoints and
the builder.  The eval CLI ``test`` with UPerNet and DeepLab is in
tests/test_torch_frame_baselines_cli.py.

Small sizes on the CPU, 5 classes: ResNet-18 (output stride 32) under
UPerNet-lite, ResNet-18-dilated under DeepLab and Non-local 2D (fc_dim
512), a ResNeXt of one grouped block a stage (4 groups, stage widths
16-128, fc_dim 256) under UPerNet-lite, MobileNetV2 at its own widths
(fc_dim 320) under C1 with deep supervision; 40x75 frames, bucketed in
64x128 (UPerNet at fpn_dim 512 runs in the CLI tests).
Weights: a seeded port init read into Flax variables through the JAX
importers, the BatchNorm statistics perturbed (the non-local block's
residual scale with them, so the attention is live), and carried back by
``convert.py``; JAX's side is jitted and builds no init of its own.  Bars
as tests/test_torch_frame.py: logits within 1e-5 of the largest (1e-4 at
least), PNGs identical and metrics equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2021_vspw_implement_tpu.models import resnet as jresnet
from cvpr2021_vspw_implement_tpu.models import segmentation as jseg
from cvpr2021_vspw_implement_tpu.models.builder import \
    ModelBuilder as JaxModelBuilder
from cvpr2021_vspw_implement_tpu.models.import_torch import (
    import_decoder_by_arch, import_encoder_by_arch)
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.models import (decoders, deeplab,
                                                      resnet, segmentation)
from cvpr2021_vspw_implement_tpu_torch.models.builder import ModelBuilder
from cvpr2021_vspw_implement_tpu_torch.models.layers import init_weights
from cvpr2021_vspw_implement_tpu_torch.ops import masked
from cvpr2021_vspw_implement_tpu_torch.ops.interpolate import resize_bilinear
from cvpr2021_vspw_implement_tpu_torch.pretrained import \
    load_reference_weights
from torch_port_util import (assert_trees_equal, numpy_tree,
                             perturb_batchnorm, to_nchw, to_nhwc)

K = 5
H, W = 40, 75
PAD = masked.bucket_hw(H, W)                                  # (64, 128)
TINY_RESNEXT = dict(layers=(1, 1, 1, 1), groups=4,
                    stage_planes=(16, 32, 64, 128))
#: name → (encoder, decoder, fc_dim); "resnext" is the tiny ResNeXt
PAIRS = {
    "resnet18-upernet_lite": ("resnet18", "upernet_lite", 512),
    "resnext-upernet_lite": ("resnext", "upernet_lite", 256),
    "resnet18dilated-deeplab": ("resnet18dilated", "deeplab", 512),
    "resnet18dilated-nonlocal2d": ("resnet18dilated", "nonlocal2d", 512),
    "mobilenetv2dilated-c1_deepsup": ("mobilenetv2dilated", "c1_deepsup",
                                      320),
}


def _trunks(arch):
    """(port trunk, JAX trunk, the arch name JAX's importer dispatches)."""
    if arch == "resnext":
        return (resnet.ResNetFeatures(resnet.GroupBottleneck, **TINY_RESNEXT),
                jresnet.ResNetFeatures(block=jresnet.GroupBottleneck,
                                       **TINY_RESNEXT), "resnext101")
    return (ModelBuilder.build_encoder(arch),
            JaxModelBuilder.build_encoder(arch), arch)


def _variables(port, enc_arch, dec_arch, seed):
    """Flax variables of ``port``'s weights through the JAX importers
    (``import_torch.py``'s dispatch), BatchNorm perturbed."""
    enc = import_encoder_by_arch(enc_arch, port.encoder.state_dict())
    dec = import_decoder_by_arch(dec_arch, port.decoder.state_dict())
    return perturb_batchnorm({c: {"encoder": enc[c], "decoder": dec[c]}
                              for c in ("params", "batch_stats")}, seed)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX model, variables, port model in eval mode) of ``PAIRS[name]``."""
    enc, dec, fc = PAIRS[name]
    port_enc, jax_enc, enc_arch = _trunks(enc)
    port = segmentation.SegmentationModule(
        port_enc, ModelBuilder.build_decoder(dec, fc_dim=fc, num_class=K))
    init_weights(port, torch.Generator().manual_seed(len(name)))
    variables = _variables(port, enc_arch, dec, seed=3)
    jmodel = jseg.SegmentationModule(
        jax_enc, JaxModelBuilder.build_decoder(dec, fc_dim=fc, num_class=K))
    return jmodel, variables, load_jax_variables(port, variables).eval()


def _close(got, want, what="", rel=1e-5):
    tol = max(1e-4, rel * float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max |diff| {err:.3e} above {tol:.3e}"


def _img(seed, h=H, w=W):
    return np.random.default_rng(seed).standard_normal(
        (1, h, w, 3)).astype(np.float32)


def _jax_logits(jmodel, variables, img, valid_hw=None):
    kw = {} if valid_hw is None else {
        "valid_hw": tuple(jnp.int32(v) for v in valid_hw)}
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(lambda v, x: jmodel.apply(
            v, x, train=False, **kw))(variables, jnp.asarray(img))[0])


def _port_runs(port, img):
    """(exact logits, bucketed logits on the padded grid) of the port."""
    imgp = np.zeros((1, *PAD, 3), np.float32)
    imgp[:, :H, :W] = img
    with torch.inference_mode():
        return port(to_nchw(img))[0], port(to_nchw(imgp),
                                           valid_hw=(H, W))[0]


@pytest.mark.parametrize("name", PAIRS)
def test_logits_match_jax_exact_and_bucketed(name):
    """Eval logits at exact shapes against JAX's; the port's bucketed run
    (64x128, true size 40x75) on its valid region against its exact run
    and JAX's exact run; JAX's own bucketed run against its exact one
    (they agree for these heads: nothing for ROADMAP Queue C)."""
    jmodel, variables, port = _pair(name)
    img = _img(1)
    want = _jax_logits(jmodel, variables, img)
    imgp = np.zeros((1, *PAD, 3), np.float32)
    imgp[:, :H, :W] = img
    want_b = _jax_logits(jmodel, variables, imgp, (H, W))
    exact, bucketed = _port_runs(port, img)
    hv, wv = masked.feature_valid(*bucketed.shape[-2:], (H, W), PAD)
    assert (hv, wv) == tuple(exact.shape[-2:]) == want.shape[1:3]
    _close(to_nhwc(exact), want, f"{name} exact vs JAX")
    _close(bucketed[..., :hv, :wv].numpy(), exact.numpy(),
           f"{name} bucketed vs exact")
    _close(to_nhwc(bucketed)[:, :hv, :wv], want,
           f"{name} bucketed vs JAX exact")
    _close(want_b[:, :hv, :wv], want, f"{name} JAX bucketed vs JAX exact")


def _padded_top_down(f, size, *_):
    return resize_bilinear(f, size)


def _padded_pool(x, _):
    return x.mean(dim=(2, 3), keepdim=True)


@pytest.mark.parametrize("name,owner,attr,fault", [
    ("resnet18-upernet_lite", decoders.UPerNet, "top_down",
     staticmethod(_padded_top_down)),
    ("resnet18dilated-deeplab", deeplab, "global_avg_pool_rt", _padded_pool),
])
def test_planted_fault_fails_the_bucketed_check(name, owner, attr, fault):
    """A head that reads a padded size in bucketed eval must fail the
    bucketed-vs-exact check: UPerNet's top-down resize on the padded grid
    (``F.interpolate`` of the whole level), DeepLab's image pool over the
    padded grid (band included)."""
    _, _, port = _pair(name)
    img = _img(2)
    saved = owner.__dict__[attr]
    setattr(owner, attr, fault)
    try:
        exact, bucketed = _port_runs(port, img)
    finally:
        setattr(owner, attr, saved)
    hv, wv = exact.shape[-2:]
    with pytest.raises(AssertionError, match="bucketed vs exact"):
        _close(bucketed[..., :hv, :wv].numpy(), exact.numpy(),
               f"{name} bucketed vs exact")


@pytest.mark.parametrize("name", PAIRS)
def test_weights_round_trip(name):
    """Port → the JAX importers → ``load_jax_variables`` into a fresh model
    gives every tensor back (the trunk alone too); the tree has the shapes
    of JAX's own model (traced, not compiled)."""
    jmodel, variables, port = _pair(name)
    enc, dec, fc = PAIRS[name]
    fresh = load_jax_variables(segmentation.SegmentationModule(
        _trunks(enc)[0], ModelBuilder.build_decoder(dec, fc, K)), variables)
    trunk = load_jax_variables(_trunks(enc)[0], {
        c: variables[c]["encoder"] for c in ("params", "batch_stats")})
    want = port.state_dict()
    for key, t in [*fresh.state_dict().items(),
                   *(("encoder." + k, t)
                     for k, t in trunk.state_dict().items())]:
        torch.testing.assert_close(t, want[key], rtol=0, atol=0)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "dropout": key}, jnp.zeros((2, 64, 64, 3)),
        train=True))
    assert jax.tree_util.tree_map(lambda a: a.shape, dict(shapes)) == \
        jax.tree_util.tree_map(lambda a: a.shape, variables)


@pytest.mark.parametrize("arch,extra", [
    ("mobilenetv2dilated", {"features.18.0.weight": torch.zeros(1280, 320,
                                                                1, 1),
                            "classifier.1.weight": torch.zeros(10, 1280)}),
    ("resnext", {"fc.weight": torch.zeros(10, 256)}),
    ("resnet18", {"fc.weight": torch.zeros(10, 512),
                  "fc.bias": torch.zeros(10)}),
])
def test_reference_encoder_checkpoints(arch, extra, tmp_path):
    """A reference encoder checkpoint (``module.`` prefixed, with its
    classification head) loads strict through ``--torch_enc`` /
    ``--pre_enc`` (pretrained.py), and the JAX importer, by its dispatch
    on the arch name, reads the same file into the same tree as the port's
    own ``state_dict()``."""
    src, _, jax_arch = _trunks(arch)
    init_weights(src, torch.Generator().manual_seed(5))
    path = str(tmp_path / "enc.pth")
    torch.save({"module." + k: v for k, v in
                {**src.state_dict(), **extra}.items()}, path)
    cfg = port_default_cfg.clone()
    cfg.MODEL.arch_encoder = jax_arch
    model = segmentation.SegmentationModule(
        _trunks(arch)[0], ModelBuilder.build_decoder("c1"))
    load_reference_weights(model, cfg, encoder=path, strict=True)
    for key, t in src.state_dict().items():
        torch.testing.assert_close(model.encoder.state_dict()[key], t,
                                   rtol=0, atol=0)
    assert_trees_equal(
        numpy_tree(import_encoder_by_arch(jax_arch, torch.load(path))),
        numpy_tree(import_encoder_by_arch(jax_arch, src.state_dict())))


def test_builder_builds_every_jax_name():
    """Every encoder and decoder name of JAX's ``ModelBuilder`` builds in
    the port (``hrnetv2_clip`` aside, which names its CLI); unknown names
    raise ``ValueError``; a trunk whose channels UPerNet or DeepLab cannot
    read is refused naming the channels they expect.  (Built on the meta
    device: no weights are made.)"""
    with torch.device("meta"):
        for arch in ("mobilenetv2dilated", "resnet18", "resnet18dilated",
                     "resnet50", "resnet50dilated", "resnet101",
                     "resnet101dilated", "resnext101", "hrnetv2"):
            assert arch in ModelBuilder.ENCODERS
            ModelBuilder.build_encoder(arch)
        for arch in ("c1_deepsup", "c1", "ppm", "ppm_deepsup",
                     "ppm_deepsup_clip", "ppm_clip", "upernet_lite",
                     "upernet", "deeplab", "nonlocal2d", "ocrnet_deepsup"):
            assert arch in ModelBuilder.DECODERS
            ModelBuilder.build_decoder(arch, 2048, K)
        up = ModelBuilder.build_decoder("upernet", 2048, K)
        lite = ModelBuilder.build_decoder("upernet_lite", 2048, K)
        x = ModelBuilder.build_encoder("resnext101")
    assert up.conv_last_[0][0].in_channels == 4 * 512
    assert lite.fpn_in[0][0].out_channels == 256
    assert [blk.conv2.groups for blk in x.layer1] == [32] * 3
    assert x.layer4[0].conv3.out_channels == 2048
    assert len(x.layer3) == 23 and x.layer4[0].conv2.stride == (2, 2)
    with pytest.raises(ValueError, match="test_clip --method hrnetv2_clip"):
        ModelBuilder.build_encoder("hrnetv2_clip")
    with pytest.raises(ValueError, match="unknown encoder"):
        ModelBuilder.build_encoder("resnet34")
    with pytest.raises(ValueError, match="unknown decoder"):
        ModelBuilder.build_decoder("fcn")
    levels = [torch.zeros(1, c, 4, 4) for c in (24, 32, 64, 160, 320)]
    with pytest.raises(ValueError, match=r"\(40, 80, 160, 320\)"):
        ModelBuilder.build_decoder("upernet", 320, K)(levels)
    with pytest.raises(ValueError, match=r"\(40, 320\)"):
        ModelBuilder.build_decoder("deeplab", 320, K)(levels)

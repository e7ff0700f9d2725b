"""The per-frame trainer ``train`` with the new baselines, against JAX
``train.train`` and on its own, and their reference decoder checkpoints.

(a) Loss curves of UPerNet and DeepLabV3+ (their R101 presets on
    ResNet-18-dilated), fc_dim 512, 5 classes: 3 steps within rtol 1e-2
    (the JAX package's curve-parity bar), batch 4 of 48x48 crops (at batch
    2 BatchNorm's one-pass variance in JAX parts the curves), LR 0.005 (at
    0.01 DeepLab's third loss parted by 1.5-2.4%: its image-pool branch
    batch-normalises one value a frame), the same ``FrameDataset`` batches
    through both loaders.  Both start from the port's seeded init: the JAX
    trainer's model takes it, through the JAX importers, for its own init
    (which it then does not build), and the port's trainer reads it as its
    ``MODEL.weights_encoder`` / ``weights_decoder``.  Dropout is off on
    both sides: the port's by its override, JAX's DeepLab dropouts (plain
    flax ``nn.Dropout``, which no override reaches) by a method
    interceptor, as tests/test_torch_train_tdnet_nl3d.py.
(b) The trainer runs MobileNetV2 + C1 with deep supervision (two logits
    maps) and Non-local 2D (one), losses finite and weights moved.
(c) A reference checkpoint of each new head (``module.`` prefixed) loads
    through ``--pre_dec`` as it is, and JAX's importer reads the same file.
(d) One training step of the output-stride-32 ResNet-18 under
    UPerNet-lite against JAX's, in float64 on both sides: the loss, every
    gradient and the running statistics (the curves of (a) run on the
    dilated trunk only).
"""

import argparse
import copy
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2021_vspw_implement_tpu import train as jax_train
from cvpr2021_vspw_implement_tpu.config import cfg as jax_default_cfg
from cvpr2021_vspw_implement_tpu.models import layers as jlayers
from cvpr2021_vspw_implement_tpu.models import segmentation as jseg
from cvpr2021_vspw_implement_tpu.models.import_torch import \
    import_decoder_by_arch
from cvpr2021_vspw_implement_tpu_torch import test as port_test
from cvpr2021_vspw_implement_tpu_torch import train as port_train
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.data import make_synthetic_vspw
from cvpr2021_vspw_implement_tpu_torch.models import layers
from cvpr2021_vspw_implement_tpu_torch.models.builder import ModelBuilder
from cvpr2021_vspw_implement_tpu_torch.models.layers import init_weights
from cvpr2021_vspw_implement_tpu_torch.pretrained import apply_pretrained_init
from cvpr2021_vspw_implement_tpu_torch.models import segmentation
from test_torch_frame_baselines import K, _pair, _variables
from test_torch_train_propnet_f64 import _f64, _jax_float64
from torch_port_util import assert_trees_equal, numpy_tree


def _preset(name, package=port_train):
    return os.path.join(os.path.dirname(package.__file__), "config",
                        "presets", name)


#: head → its preset, run on ResNet-18-dilated (on the output-stride-32
#: ResNet-18 a 48 crop leaves C5 2x2, and UPerNet's pyramid branches
#: batch-normalise 4 values a channel at batch 4: there JAX's third loss
#: moved by 3% from one run to the next)
CURVES = {"upernet": "vsp-resnet101-upernet.yaml",
          "deeplab": "vsp-resnet101dilated-deeplab.yaml"}


@pytest.fixture(scope="module")
def vspw_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vspw_train_baselines")
    make_synthetic_vspw(str(root), num_videos=12, frames_per_video=1,
                        size=(48, 64), num_class=K, seed=14)
    return str(root)


def _args(root, **kw):
    base = dict(dataroot=root, num_class=K, batchsize=4, cropsize=48,
                trainfps=15, multi_scale=True, lr=0.01, totalepoch=1,
                weight_decay=1e-4, lesslabel=False, train_filter=False,
                use_clipdataset=False, usetwodata=False, resume=False,
                use_float16=False, refrng=False, profile_dir="",
                device="cpu", seed=None)
    base.update(kw)
    return argparse.Namespace(**base)


def _cfgs(dec, tmp_path):
    preset = CURVES[dec]
    over = ["MODEL.arch_encoder", "resnet18dilated", "MODEL.fc_dim", "512"]
    pcfg = port_default_cfg.clone()
    pcfg.merge_from_file(_preset(preset))
    pcfg.merge_from_list(over + ["DIR", str(tmp_path / "port_ckpt")])
    jcfg = jax_default_cfg.clone()
    jcfg.merge_from_file(_preset(preset, jax_train))
    jcfg.merge_from_list(over + ["DIR", str(tmp_path / "jax_ckpt")])
    jcfg.TPU.compute_dtype = "float32"
    return pcfg, jcfg


def _no_flax_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, flax.linen.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.fixture()
def no_dropout():
    jlayers.set_dropout_override(0.0)
    layers.set_dropout_override(0.0)
    yield
    jlayers.set_dropout_override(None)
    layers.set_dropout_override(None)


@pytest.mark.parametrize("dec", sorted(CURVES))
def test_train_curve_matches_jax(vspw_root, tmp_path, monkeypatch,
                                 no_dropout, dec):
    pcfg, jcfg = _cfgs(dec, tmp_path)
    args = _args(vspw_root, lr=0.005)
    port = port_test.build_segmentation(pcfg, K)
    init_weights(port, torch.Generator().manual_seed(21))
    with torch.no_grad():
        # the classifier starts small (logits of a few units), as the
        # curves of tests/test_torch_train_ocr_netwarp.py
        for m in port.decoder.modules():
            if isinstance(m, torch.nn.Conv2d) and m.out_channels == K:
                m.weight.mul_(0.1)
    start = _variables(port, pcfg.MODEL.arch_encoder, dec, seed=22)
    enc_path, dec_path = str(tmp_path / "enc.pth"), str(tmp_path / "dec.pth")
    load_jax_variables(port, start)
    torch.save(port.encoder.state_dict(), enc_path)
    torch.save(port.decoder.state_dict(), dec_path)
    # the JAX trainer's model takes the port's weights for its init: its
    # own init runs eagerly and compiles op by op (about 30 s here)
    monkeypatch.setattr(jseg.SegmentationModule, "init",
                        lambda self, *a, **kw: jax.tree_util.tree_map(
                            jnp.asarray, start))

    jax_losses, port_losses = [], []
    make_step = jax_train.make_train_step

    def recording_make_step(*a, **kw):
        step = make_step(*a, **kw)

        def recorded(state, batch, rng):
            state, metrics = step(state, batch, rng)
            jax_losses.append(float(metrics["loss"]))
            return state, metrics
        return recorded

    monkeypatch.setattr(jax_train, "make_train_step", recording_make_step)
    step = port_train.train_step

    def recorded_port(*a):
        metrics = step(*a)
        port_losses.append(metrics["loss"].item())
        return metrics

    monkeypatch.setattr(port_train, "train_step", recorded_port)
    with jax.default_matmul_precision("highest"), \
            flax.linen.intercept_methods(_no_flax_dropout):
        jax_train.train(jcfg, args)
    pcfg.MODEL.weights_encoder, pcfg.MODEL.weights_decoder = (enc_path,
                                                              dec_path)
    model = port_train.train(pcfg, args)
    got, want = np.array(port_losses), np.array(jax_losses)
    print(f"\n{dec} train: port losses {got}, JAX losses {want}, max "
          f"relative difference {np.max(np.abs(got - want) / want):.2e}")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-2)
    assert np.ptp(want) > 1e-3 * want[0]
    assert model.training


@pytest.mark.parametrize("preset,over,n_out", [
    ("vsp-mobilenetv2dilated-c1_deepsup.yaml", [], 2),
    ("vsp-resnet101dilated-nonlocal2d.yaml",
     ["MODEL.arch_encoder", "resnet18dilated", "MODEL.fc_dim", "512"], 1),
])
def test_trainer_runs_new_pairs(vspw_root, tmp_path, preset, over, n_out):
    """Two steps of ``train`` at batch 4: finite losses, the trunk's first
    conv and the classifier moved; MobileNetV2 + C1 trains with deep
    supervision (two logits maps), Non-local 2D with one."""
    cfg = port_default_cfg.clone()
    cfg.merge_from_file(_preset(preset))
    cfg.merge_from_list(over + ["DIR", str(tmp_path / "ckpt")])
    outs, before = [], {}
    step = port_train.train_step

    def recorded(model, optimizer, scheduler, batch, loss_fn):
        if not before:
            before.update({n: p.detach().clone()
                           for n, p in model.named_parameters()})
        return step(model, optimizer, scheduler, batch,
                    lambda o, b: (outs.append(len(o)), loss_fn(o, b))[1])

    port_train.train_step = recorded
    try:
        model = port_train.train(cfg, _args(vspw_root, lr=0.02),
                                 max_steps=2)
    finally:
        port_train.train_step = step
    assert outs == [n_out, n_out]
    after = dict(model.named_parameters())
    first = next(n for n in after if n.startswith("encoder."))
    last = [n for n in after if n.startswith("decoder.")][-2]
    for name in (first, last):
        assert not torch.equal(after[name].detach(), before[name]), name
    assert all(torch.isfinite(p).all() for p in after.values())


@pytest.mark.parametrize("dec", ["upernet", "upernet_lite", "deeplab",
                                 "nonlocal2d"])
def test_pre_dec_loads_reference_head(tmp_path, dec):
    """A reference checkpoint of the head (``module.`` prefixed, the
    ``num_batches_tracked`` counters in it) loads through ``--pre_dec``
    as it is; JAX's ``import_decoder_by_arch`` reads the same file into the
    tree of the port's own ``state_dict()``."""
    src = ModelBuilder.build_decoder(dec, 512, K)
    init_weights(src, torch.Generator().manual_seed(31))
    path = str(tmp_path / "dec.pth")
    torch.save({"module." + k: v for k, v in src.state_dict().items()}, path)
    cfg = port_default_cfg.clone()
    cfg.MODEL.arch_encoder, cfg.MODEL.arch_decoder = "resnet18", dec
    cfg.MODEL.fc_dim = 512
    model = port_test.build_segmentation(cfg, K)
    apply_pretrained_init(model, cfg, argparse.Namespace(pre_enc="",
                                                         pre_dec=path))
    for key, t in src.state_dict().items():
        torch.testing.assert_close(model.decoder.state_dict()[key], t,
                                   rtol=0, atol=0)
    assert_trees_equal(
        numpy_tree(import_decoder_by_arch(dec, torch.load(path))),
        numpy_tree(import_decoder_by_arch(dec, src.state_dict())))


def test_stride32_train_step_matches_jax():
    """Training mode, float64 on both sides: ResNet-18 at output stride 32
    under UPerNet-lite (no dropout), a batch of 4 64x64 frames, the
    reference loss order (``upsampled_logprob_loss``), a few labels
    ignored.  The loss, every gradient and the running statistics after
    the step against ``jax.value_and_grad`` through ``apply(train=True,
    mutable)``.  Float64, because at this size C5 is 2x2 and the pyramid
    batch-normalises 4-16 values a channel: in float32 that step is ill
    conditioned (the reason the curves of
    :func:`test_train_curve_matches_jax` run on the dilated trunk).  The
    loss within 1e-6: the port's NLL picks its log-probabilities in
    float32 (``nll_from_logprobs``)."""
    jmodel, variables, port = _pair("resnet18-upernet_lite")
    rng = np.random.default_rng(41)
    img = rng.standard_normal((4, 64, 64, 3))
    lab = rng.integers(0, K, (4, 64, 64)).astype(np.int32)
    lab[:, :3, :7] = 255
    v64 = _f64(variables)
    with _jax_float64():
        def loss_fn(params):
            (logits,), mut = jmodel.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                jnp.asarray(img), train=True, mutable=["batch_stats"])
            return jseg.upsampled_logprob_loss(logits, jnp.asarray(lab)), mut

        (jl, mut), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"])
        jl, jg, mut = jax.tree_util.tree_map(np.asarray, (jl, jg, mut))
    model = copy.deepcopy(port).double().train()
    (logits,) = model(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert logits.shape[-2:] == (16, 16)
    pl = segmentation.upsampled_logprob_loss(logits,
                                             torch.from_numpy(lab).long())
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-6)
    want = load_jax_variables(copy.deepcopy(port).double(), {
        "params": jg, "batch_stats": v64["batch_stats"]})
    grads = {n: p.grad for n, p in model.named_parameters()}
    worst = 0.0
    for n, w in want.named_parameters():
        w = w.detach()
        gap = float((grads[n] - w).abs().max() / w.abs().max())
        worst = max(worst, gap)
        assert gap <= 1e-4, f"{n}: {gap:.2e} of the largest element"
    stats = load_jax_variables(copy.deepcopy(port).double(), {
        "params": v64["params"], "batch_stats": mut["batch_stats"]})
    buffers = dict(model.named_buffers())
    worst_stat = 0.0
    for n, b in stats.named_buffers():
        if not n.endswith("num_batches_tracked"):
            gap = float((buffers[n] - b).abs().max() / b.abs().max())
            worst_stat = max(worst_stat, gap)
            assert gap <= 1e-6, f"{n}: {gap:.2e} of the largest element"
    print(f"\nR18 (stride 32) + upernet_lite train step, float64: loss "
          f"{pl.item():.9f} (JAX {float(jl):.9f}); gradients at most "
          f"{worst:.2e} and running statistics {worst_stat:.2e} of their "
          "largest element from JAX's")

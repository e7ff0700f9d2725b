"""The port's pretrained init (``--pre_enc`` / ``--pre_dec``,
``cfg.MODEL.weights_encoder`` / ``weights_decoder``) against the JAX
package's ``apply_pretrained_init``, on the CPU.

Reference-format checkpoints are written with ``torch.save`` from a second
seeded port init: the encoder's ``state_dict``, and a decoder's under the
per-frame ``PPMDeepsup`` names (``conv_last``, ``conv_last_deepsup``, a
``module.`` prefix, a per-frame classifier ``conv_last.4`` that the clip
decoders lack).  The model's own seeded init goes to JAX through its
importers; JAX overlays the checkpoints (``merge_variables``), the port
loads them (``pretrained.py``), and the two results must be equal
parameter for parameter through ``convert.load_jax_variables``.  R18
preset, 5 classes; no JAX compile, a few seconds.
"""

import os

import pytest
import torch

from cvpr2021_vspw_implement_tpu.config import cfg as jax_default_cfg
from cvpr2021_vspw_implement_tpu.models.import_torch import (
    apply_pretrained_init as jax_apply_pretrained_init,
    import_clip_psp_state_dict, import_clip_warp_state_dict,
    import_etc_state_dict)
from cvpr2021_vspw_implement_tpu_torch import train_clip
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.config.args import (
    build_train_clip_parser, postprocess_args)
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.methods import build_method
from cvpr2021_vspw_implement_tpu_torch.models.layers import init_weights
from cvpr2021_vspw_implement_tpu_torch.pretrained import apply_pretrained_init
from torch_port_util import perturb_port_batchnorm

K = 5
PRESET = os.path.join(os.path.dirname(__file__), os.pardir,
                      "cvpr2021_vspw_implement_tpu_torch", "config", "presets",
                      "vsp-resnet18dilated-ppm_deepsup_clip.yaml")
# method: (its flags, the JAX importer of its state_dict)
METHODS = {
    "clip_psp": ([], import_clip_psp_state_dict),
    "ETC": (["--clip_num", "2", "--dilation_num", "0"],
            import_etc_state_dict),
    "our_warp": ([], import_clip_warp_state_dict),
}


def _setup(method, flags=()):
    args = build_train_clip_parser().parse_args(
        ["--cfg", PRESET, "--dataroot", "unused", "--method", method,
         "--num_class", str(K), *METHODS[method][0], *flags])
    postprocess_args(args)
    cfg = port_default_cfg.clone()
    cfg.merge_from_file(args.cfg)
    cfg.DATASET.num_class = K
    jcfg = jax_default_cfg.clone()
    for key in ("arch_encoder", "arch_decoder", "fc_dim"):
        setattr(jcfg.MODEL, key, getattr(cfg.MODEL, key))
    return args, cfg, jcfg


def _model(method, cfg, args, seed):
    model, _ = build_method(method, cfg, args)
    init_weights(model, torch.Generator().manual_seed(seed))
    return perturb_port_batchnorm(model, seed + 10)


def _checkpoints(tmp_path):
    """(encoder .pth, per-frame-named decoder .pth, their donor): the donor
    is a second seeded our_warp init (the encoder is every method's R18, the
    decoder ETC's and our_warp's ``PPMDeepsupClip``)."""
    args, cfg, _ = _setup("our_warp")
    donor = _model("our_warp", cfg, args, 7)
    enc = tmp_path / "encoder_epoch_20.pth"
    torch.save(donor.encoder.state_dict(), enc)
    per_frame = {"conv_last_": "conv_last",
                 "conv_last_deepsup_": "conv_last_deepsup"}
    dec_sd = {}
    for name, t in donor.decoder.state_dict().items():
        head, dot, rest = name.partition(".")
        dec_sd["module." + per_frame.get(head, head) + dot + rest] = t
    dec_sd["module.conv_last.4.weight"] = torch.ones(K, 512, 1, 1)
    dec_sd["module.conv_last.4.bias"] = torch.ones(K)
    dec = tmp_path / "decoder_epoch_20.pth"
    torch.save(dec_sd, dec)
    return str(enc), str(dec), donor


def _both(method, args, cfg, jcfg):
    """The port's init with the pretrained init applied, and JAX's result
    carried into a second copy of that init."""
    port = _model(method, cfg, args, 0)
    variables = METHODS[method][1](port.state_dict())
    merged = jax_apply_pretrained_init(variables, jcfg, args)
    want = load_jax_variables(_model(method, cfg, args, 0), merged)
    return apply_pretrained_init(port, cfg, args), want


def _assert_same(got, want):
    a, b = got.state_dict(), want.state_dict()
    assert a.keys() == b.keys()
    for name in a:
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("method", ["clip_psp", "ETC"])
def test_pretrained_init_matches_jax(tmp_path, method):
    """ETC: encoder and decoder load; clip_psp has no decoder, and
    ``--pre_dec`` is ignored as in JAX (tests/test_pretrained_init.py)."""
    enc, dec, donor = _checkpoints(tmp_path)
    args, cfg, jcfg = _setup(method, ["--pre_enc", enc, "--pre_dec", dec])
    got, want = _both(method, args, cfg, jcfg)
    _assert_same(got, want)
    assert torch.equal(got.encoder.conv1.weight, donor.encoder.conv1.weight)
    if method == "ETC":
        for name in ("conv_last_.0.weight", "cbr_deepsup.0.weight",
                     "conv_last_deepsup_.weight"):
            assert torch.equal(got.decoder.state_dict()[name],
                               donor.decoder.state_dict()[name]), name
        # what no checkpoint holds keeps its init
        assert torch.equal(got.conv_last_[0].weight,
                           _model(method, cfg, args, 0).conv_last_[0].weight)


def test_pretrained_init_from_cfg_weights(tmp_path, monkeypatch):
    """``MODEL.weights_encoder`` / ``weights_decoder`` in place of the flags
    (our_warp); and the trainer applies them after its init and before it
    builds its data and optimizer."""
    enc, dec, donor = _checkpoints(tmp_path)
    args, cfg, jcfg = _setup("our_warp")
    cfg.MODEL.weights_encoder = jcfg.MODEL.weights_encoder = enc
    cfg.MODEL.weights_decoder = jcfg.MODEL.weights_decoder = dec
    got, want = _both("our_warp", args, cfg, jcfg)
    _assert_same(got, want)
    assert torch.equal(got.encoder.conv1.weight, donor.encoder.conv1.weight)
    assert torch.equal(got.decoder.cbr_deepsup[0].weight,
                       donor.decoder.cbr_deepsup[0].weight)

    class Built(Exception):
        pass

    def stop(model, generator):
        raise Built(model)

    monkeypatch.setattr(train_clip, "set_dropout_generator", stop)
    args.device, args.seed = "cpu", 0
    with pytest.raises(Built) as built:
        train_clip.train_clip(cfg, args)
    model = built.value.args[0]
    assert torch.equal(model.encoder.conv1.weight, donor.encoder.conv1.weight)
    assert torch.equal(model.decoder.cbr_deepsup[0].weight,
                       donor.decoder.cbr_deepsup[0].weight)

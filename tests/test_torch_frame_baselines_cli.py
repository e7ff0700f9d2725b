"""The per-frame eval CLI ``test`` with the UPerNet and DeepLabV3+ heads
against the JAX CLI (JAX ``test.evaluate``): each head's R101 preset with
the ResNet-18-dilated overrides (``MODEL.arch_encoder resnet18dilated
MODEL.fc_dim 512``), 5 classes, two videos of two 40x53 frames, exact
(``--width_bucket 0``) and bucketed in 64x64.  The same weights on both
sides (a seeded port init through the JAX importers and back,
tests/test_torch_frame_baselines.py); PNGs identical, metrics equal.  JAX
compiles and traces its two heads for most of the time here.
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cvpr2021_vspw_implement_tpu import test as jax_test
from cvpr2021_vspw_implement_tpu.config import cfg as jax_default_cfg
from cvpr2021_vspw_implement_tpu_torch import test as port_test
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.data import make_synthetic_vspw
from cvpr2021_vspw_implement_tpu_torch.models.layers import init_weights
from test_torch_frame_baselines import K, _variables


@pytest.fixture(scope="module")
def vspw_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vspw_baselines")
    make_synthetic_vspw(str(root), num_videos=2, frames_per_video=2,
                        size=(40, 53), num_class=K, seed=13)
    return str(root)


def _pngs(d):
    return {os.path.join(v, f): np.asarray(Image.open(os.path.join(d, v, f)))
            for v in sorted(os.listdir(d)) if v != "vmiou.pkl"
            for f in sorted(os.listdir(os.path.join(d, v)))}


#: the R101 preset of each head; the CLI runs them on ResNet-18-dilated
CLI_PRESETS = {"deeplab": "vsp-resnet101dilated-deeplab.yaml",
               "upernet": "vsp-resnet101-upernet.yaml"}
R18 = ["MODEL.arch_encoder", "resnet18dilated", "MODEL.fc_dim", "512"]


@pytest.mark.parametrize("bucket", [0, 64])
@pytest.mark.parametrize("dec", sorted(CLI_PRESETS))
def test_cli_matches_jax(vspw_root, tmp_path, dec, bucket):
    """``test`` with the head's R101 preset and the R18 overrides against
    JAX ``test.evaluate`` on the same weights: identical PNGs and equal
    metrics, exact and bucketed (40x53 in 64x64)."""
    preset = os.path.join(os.path.dirname(port_test.__file__), "config",
                          "presets", CLI_PRESETS[dec])
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    args = port_test.build_eval_parser().parse_args(
        ["--cfg", preset, "--dataroot", vspw_root, "--num_class", str(K),
         "--width_bucket", str(bucket), "--saveroot", pdir, "--device",
         "cpu", *R18])
    cfg = port_default_cfg.clone()
    cfg.merge_from_file(preset)
    cfg.merge_from_list(args.opts)
    port = port_test.build_segmentation(cfg, K)
    init_weights(port, torch.Generator().manual_seed(11))
    variables = _variables(port, "resnet18dilated", dec, seed=12)
    port = load_jax_variables(port, variables).eval()
    got, got_v = port_test.evaluate(cfg, args, model=port, is_save=True)

    jcfg = jax_default_cfg.clone()
    jcfg.merge_from_file(os.path.join(os.path.dirname(jax_test.__file__),
                                      "config", "presets", CLI_PRESETS[dec]))
    jcfg.merge_from_list(R18)
    jcfg.TPU.compute_dtype = "float32"
    jargs = argparse.Namespace(**{**vars(args), "saveroot": jdir})
    with jax.default_matmul_precision("highest"):
        want, want_v = jax_test.evaluate(
            jcfg, jargs,
            variables=jax.tree_util.tree_map(jnp.asarray, variables),
            is_save=True)
    for key in want:
        assert got[key] == want[key], key
    assert got_v == want_v
    assert got["buckets"] == ([(64, 64)] if bucket else [])
    a, b = _pngs(pdir), _pngs(jdir)
    assert sorted(a) == sorted(b) and len(a) == 4
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)

"""``test_clip --torch_load`` against the JAX CLI's.

A seeded clip_psp (ResNet-18-dilated, BatchNorm perturbed) saved as a
DataParallel ``.pth`` (``module.`` names), read by both CLIs' eval at exact
shapes over a 10-frame fixture: identical prediction PNGs.  The methods
``--torch_load`` takes are JAX's ``FUSED_IMPORTERS``; another is refused by
name before a model is built.
"""

import argparse
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from cvpr2021_vspw_implement_tpu import test_clip as jax_test_clip
from cvpr2021_vspw_implement_tpu.config import cfg as jax_default_cfg
from cvpr2021_vspw_implement_tpu.models import import_torch as jimport
from cvpr2021_vspw_implement_tpu_torch import test_clip
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.config.args import TEMPORAL_METHODS
from cvpr2021_vspw_implement_tpu_torch.data import make_synthetic_vspw
from cvpr2021_vspw_implement_tpu_torch.models.clip_psp import build_clip_psp
from cvpr2021_vspw_implement_tpu_torch.models.layers import init_weights
from test_torch_cli_tools import JittedInit
from torch_port_util import perturb_port_batchnorm

K = 5
PRESET = "vsp-resnet18dilated-ppm_deepsup_clip.yaml"


@pytest.fixture(autouse=True)
def drop_checkpoints(tmp_path):
    """Each test's checkpoints (~100-200 MB a file) go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("fused_load") / "vspw")
    make_synthetic_vspw(r, 1, 10, (48, 64), K, seed=41)
    return r


def test_torch_load_matches_jax(root, tmp_path, monkeypatch):
    pcfg = port_default_cfg.clone()
    pcfg.merge_from_file(os.path.join(os.path.dirname(test_clip.__file__),
                                      "config", "presets", PRESET))
    model = build_clip_psp(pcfg, K)
    init_weights(model, torch.Generator().manual_seed(3))
    perturb_port_batchnorm(model, seed=4)
    ckpt = str(tmp_path / "fused.pth")
    torch.save({"module." + k: v for k, v in model.state_dict().items()},
               ckpt)

    jcfg = jax_default_cfg.clone()
    jcfg.merge_from_file(os.path.join(
        os.path.dirname(jax_test_clip.__file__), "config", "presets",
        PRESET))
    jcfg.TPU.compute_dtype = "float32"
    jargs = jax_test_clip.build_eval_clip_parser().parse_args([
        "--cfg", PRESET, "--dataroot", root, "--num_class", str(K),
        "--method", "clip_psp", "--torch_load", ckpt, "--is_save",
        "--saveroot", str(tmp_path / "jax"), "--width_bucket", "0"])
    build = jax_test_clip.build_method
    monkeypatch.setattr(jax_test_clip, "build_method", lambda *a: (
        lambda model, loss: (JittedInit(model), loss))(*build(*a)))
    with jax.default_matmul_precision("highest"):
        jax_test_clip.evaluate_clip(jcfg, jargs, is_save=True)
    test_clip.main([
        "--cfg", os.path.join(os.path.dirname(test_clip.__file__), "config",
                              "presets", PRESET),
        "--dataroot", root, "--num_class", str(K), "--method", "clip_psp",
        "--torch_load", ckpt, "--is_save", "--saveroot",
        str(tmp_path / "port"), "--width_bucket", "0", "--device", "cpu"])
    pngs = sorted(os.listdir(tmp_path / "jax" / "video_000"))
    assert len(pngs) == 10
    assert sorted(os.listdir(tmp_path / "port" / "video_000")) == pngs
    classes = set()
    for name in pngs:
        a = np.asarray(Image.open(tmp_path / "port" / "video_000" / name))
        b = np.asarray(Image.open(tmp_path / "jax" / "video_000" / name))
        np.testing.assert_array_equal(a, b)
        classes |= set(np.unique(a).tolist())
    assert len(classes) > 1

    assert sorted(TEMPORAL_METHODS) == sorted(jimport.FUSED_IMPORTERS)
    with pytest.raises(ValueError, match="not --method hrnetv2_clip"):
        test_clip.build_model(pcfg, argparse.Namespace(
            method="hrnetv2_clip", torch_load=ckpt, load="", seed=0),
            "cpu")

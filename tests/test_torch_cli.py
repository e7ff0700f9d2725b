"""The port's eval CLIs against the JAX drivers on the synthetic fixture.

``test_clip --method clip_psp --is_save`` (streaming, exact shape) must
write the same prediction PNGs and report the same mIoU and VC as the JAX
``evaluate_clip`` with the same weights; ``tc_cal`` over those PNGs must
give the JAX ``compute_tc`` score within 1e-3 with the same RAFT weights
(nearest warping can move a label where the flow sits within rounding of
a half pixel).
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
from cvpr2021_vspw_implement_tpu.data import \
    make_synthetic_vspw as jax_make_synthetic
from cvpr2021_vspw_implement_tpu.methods import build_method
from cvpr2021_vspw_implement_tpu.models.raft import RAFT as JaxRAFT
from cvpr2021_vspw_implement_tpu.tc_cal import compute_tc, load_raft_variables
from cvpr2021_vspw_implement_tpu.test_clip import evaluate_clip
from cvpr2021_vspw_implement_tpu_torch import tc_cal, test_clip, train_clip
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.data import make_synthetic_vspw
from cvpr2021_vspw_implement_tpu_torch.models.clip_psp import build_clip_psp
from cvpr2021_vspw_implement_tpu_torch.models.raft import RAFT
from torch_port_util import perturb_batchnorm

K = 5
PRESET = os.path.join(os.path.dirname(__file__), os.pardir,
                      "cvpr2021_vspw_implement_tpu_torch", "config", "presets",
                      "vsp-resnet18dilated-ppm_deepsup_clip.yaml")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both drivers on one fixture: (root, JAX (metrics, pred dir), port
    (metrics, pred dir), tmp)."""
    tmp = tmp_path_factory.mktemp("torch_cli")
    root = str(tmp / "vspw")
    make_synthetic_vspw(root, 1, 10, (48, 64), K, seed=7)

    cfg = jax_default_cfg.clone()
    cfg.MODEL.arch_encoder = "resnet18dilated"
    cfg.MODEL.fc_dim = 512
    cfg.TPU.compute_dtype = "float32"
    jargs = argparse.Namespace(
        dataroot=root, split="val", num_class=K, method="clip_psp",
        clip_num=4, dilation_num=0, dilation2="3,6,9", vc_clip_num=8,
        lesslabel=False, use_memory=False, memory_num=8, clipocr_all=False,
        psp_weight=False, deepsup_scale=0.4, st_weight=0.1, load="",
        saveroot=str(tmp / "jax_preds"), is_save=True, width_bucket=0)
    jmodel, _ = build_method("clip_psp", cfg, jargs)
    key = jax.random.PRNGKey(0)
    v = jmodel.init({"params": key, "dropout": key},
                    jnp.zeros((4, 1, 64, 64, 3), jnp.float32), train=True)
    variables = perturb_batchnorm(
        {"params": v["params"], "batch_stats": v["batch_stats"]}, seed=2)
    with jax.default_matmul_precision("highest"):
        jmetrics, _ = evaluate_clip(cfg, jargs, variables=variables,
                                    is_save=True)

    pcfg = port_default_cfg.clone()
    pcfg.MODEL.arch_encoder = "resnet18dilated"
    pcfg.MODEL.fc_dim = 512
    ckpt = str(tmp / "clip_psp.pth")
    torch.save(load_jax_variables(build_clip_psp(pcfg, K), variables)
               .state_dict(), ckpt)
    pmetrics, _ = test_clip.main([
        "--cfg", PRESET, "--dataroot", root, "--num_class", str(K),
        "--method", "clip_psp", "--load", ckpt, "--is_save",
        "--saveroot", str(tmp / "port_preds"), "--width_bucket", "0",
        "--device", "cpu"])
    return (root, (jmetrics, str(tmp / "jax_preds")),
            (pmetrics, str(tmp / "port_preds")), tmp)


def test_synthetic_fixture_matches_jax(tmp_path):
    make_synthetic_vspw(str(tmp_path / "a"), 1, 3, (16, 20), K, seed=7)
    jax_make_synthetic(str(tmp_path / "b"), 1, 3, (16, 20), K, seed=7)
    for sub in ("val.txt", "data/video_000/origin/00000002.jpg",
                "data/video_000/mask/00000002.png"):
        with open(tmp_path / "a" / sub, "rb") as fa, \
                open(tmp_path / "b" / sub, "rb") as fb:
            assert fa.read() == fb.read()


def test_test_clip_cli_matches_jax(runs):
    _, (jm, jdir), (pm, pdir), _ = runs
    names = sorted(os.listdir(os.path.join(jdir, "video_000")))
    assert len(names) == 10
    assert sorted(os.listdir(os.path.join(pdir, "video_000"))) == names
    for n in names:
        a = Image.open(os.path.join(jdir, "video_000", n))
        b = Image.open(os.path.join(pdir, "video_000", n))
        assert b.mode == "P" and a.getpalette() == b.getpalette()
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert pm["mIoU"] == pytest.approx(jm["mIoU"], abs=1e-12)
    assert pm["VC"] == pytest.approx(jm["VC"], abs=1e-12)


def test_tc_cal_cli_matches_jax(runs):
    root, (_, jdir), (_, pdir), tmp = runs
    jraft = JaxRAFT(iters=3)
    variables = load_raft_variables("", jraft)
    targs = argparse.Namespace(
        dataroot=root, predroot=jdir, split="val", num_class=K,
        max_videos=100, raft_ckpt="", raft_iters=3, allow_random_raft=True,
        width_bucket=0)
    with jax.default_matmul_precision("highest"):
        tc_jax = compute_tc(targs)
    ckpt = str(tmp / "raft.pth")
    torch.save(load_jax_variables(RAFT(iters=3), variables).state_dict(),
               ckpt)
    tc_port = tc_cal.main([
        "--dataroot", root, "--predroot", pdir, "--num_class", str(K),
        "--raft_ckpt", ckpt, "--raft_iters", "3", "--width_bucket", "0",
        "--device", "cpu"])
    assert np.isfinite(tc_port)
    assert abs(tc_port - tc_jax) <= 1e-3


@pytest.mark.parametrize("cli", [test_clip, train_clip])
def test_compute_dtype_other_than_float32_raises(cli, tmp_path, monkeypatch):
    """The port computes in float32 only: ``TPU.compute_dtype`` exists with
    that default, and both CLIs refuse any other value (the JAX CLIs'
    default, bfloat16, included) before they build or write anything."""
    assert port_default_cfg.TPU.compute_dtype == "float32"
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="compute_dtype 'bfloat16' is not "
                                         "ported"):
        cli.main(["--cfg", PRESET, "--dataroot", str(tmp_path),
                  "--device", "cpu", "TPU.compute_dtype", "bfloat16"])
    assert os.listdir(tmp_path) == []

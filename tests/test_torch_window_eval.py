"""The port's window eval path (``test_clip --method our_warp`` and
``--method ETC``) against the JAX ``evaluate_clip`` on the synthetic
fixture.

Both sides get the same Flax variables (ResNet-18-dilated, fc_dim 512,
perturbed BatchNorm statistics; the port's through ``convert.py`` and a
``--load`` checkpoint) and the same 10-frame 48x64 video.  The PNGs they
write must be identical and mIoU and VC equal (the JAX side runs its exact
shape path, ``width_bucket=0``, at the highest matmul precision).  The
port's ``TestClipDataset`` must give the JAX windows for every frame.
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
    TestClipDataset as JaxTestClipDataset
from cvpr2021_vspw_implement_tpu.methods import build_method as jax_build
from cvpr2021_vspw_implement_tpu.test_clip import evaluate_clip
from cvpr2021_vspw_implement_tpu_torch import test_clip
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.data import (TestClipDataset,
                                                    make_synthetic_vspw)
from cvpr2021_vspw_implement_tpu_torch.methods import build_method
from torch_port_util import perturb_batchnorm

K = 5
PRESET = os.path.join(os.path.dirname(__file__), os.pardir,
                      "cvpr2021_vspw_implement_tpu_torch", "config", "presets",
                      "vsp-resnet18dilated-ppm_deepsup_clip.yaml")
# (method, JAX-side options, port flags)
RUNS = {
    "our_warp": ("our_warp", {}, []),
    "our_warp_softmax": ("our_warp", {"distsoftmax": True},
                         ["--distsoftmax", "true"]),
    "our_warp_nearest": ("our_warp", {"distnearest": True},
                         ["--distnearest", "true"]),
    "ETC": ("ETC", {"clip_num": 2}, ["--clip_num", "2"]),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("window_eval") / "vspw")
    make_synthetic_vspw(root, 1, 10, (48, 64), K, seed=7)
    return root


def _jax_args(root, saveroot, method, **kw):
    ns = argparse.Namespace(
        dataroot=root, split="val", num_class=K, method=method, clip_num=4,
        dilation_num=0, dilation2="3,6,9", vc_clip_num=8, lesslabel=False,
        use_memory=False, memory_num=8, clipocr_all=False, psp_weight=False,
        deepsup_scale=0.4, st_weight=0.1, allsup=False, allsup_scale=0.3,
        linear_combine=False, distsoftmax=False, distnearest=False, temp=3.0,
        max_distances=[2], fix=False, load="", saveroot=saveroot,
        is_save=True, width_bucket=0)
    for key, v in kw.items():
        setattr(ns, key, v)
    return ns


@pytest.mark.parametrize("run", list(RUNS))
def test_window_eval_cli_matches_jax(root, tmp_path, run):
    method, opts, flags = RUNS[run]
    cfg = jax_default_cfg.clone()
    cfg.MODEL.arch_encoder = "resnet18dilated"
    cfg.MODEL.fc_dim = 512
    cfg.TPU.compute_dtype = "float32"
    jargs = _jax_args(root, str(tmp_path / "jax"), method, **opts)
    jmodel, _ = jax_build(method, cfg, jargs)
    key = jax.random.PRNGKey(0)
    v = jmodel.init({"params": key, "dropout": key},
                    jnp.zeros((jargs.clip_num, 1, 64, 64, 3), jnp.float32),
                    train=True)
    variables = perturb_batchnorm(
        {"params": v["params"], "batch_stats": v["batch_stats"]}, seed=3)
    with jax.default_matmul_precision("highest"):
        jm, _ = evaluate_clip(cfg, jargs, variables=variables, is_save=True)

    pcfg = port_default_cfg.clone()
    pcfg.merge_from_file(PRESET)
    model, _ = build_method(method, pcfg, jargs)
    ckpt = str(tmp_path / "model.pth")
    torch.save(load_jax_variables(model, variables).state_dict(), ckpt)
    pm, _ = test_clip.main([
        "--cfg", PRESET, "--dataroot", root, "--num_class", str(K),
        "--method", method, "--max_distances", "2", *flags, "--load", ckpt,
        "--is_save", "--saveroot", str(tmp_path / "port"), "--width_bucket", "0",
        "--device", "cpu"])

    jdir, pdir = tmp_path / "jax" / "video_000", tmp_path / "port" / "video_000"
    names = sorted(os.listdir(jdir))
    assert len(names) == 10 and sorted(os.listdir(pdir)) == names
    for n in names:
        a, b = Image.open(jdir / n), Image.open(pdir / n)
        assert b.mode == "P" and a.getpalette() == b.getpalette()
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert pm["mIoU"] == pytest.approx(jm["mIoU"], abs=1e-12)
    assert pm["VC"] == pytest.approx(jm["VC"], abs=1e-12)
    assert pm["first_frame_ms"] > 0 and pm["frame_ms"] > 0


@pytest.mark.parametrize("clip_num,dilation_num",
                         [(4, 0), (2, 0), (3, 1), (5, 0), (4, 2)])
def test_test_clip_dataset_matches_jax(root, clip_num, dilation_num):
    args = argparse.Namespace(clip_num=clip_num, dilation_num=dilation_num,
                              method="our_warp", lesslabel=False)
    mine = TestClipDataset(root, "video_000", args)
    ref = JaxTestClipDataset(root, "video_000", args)
    assert len(mine) == len(ref) == 10
    for i in range(len(ref)):
        got, want = mine[i], ref[i]
        assert len(got) == len(want) == 5 and got[4] == want[4]
        assert len(got[2]) == len(want[2])
        for g, w in zip([got[0], got[1], *got[2], *got[3]],
                        [want[0], want[1], *want[2], *want[3]]):
            np.testing.assert_array_equal(g, w)


def test_our_warp_eval_defaults_to_cuda(root):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_clip.main(["--cfg", PRESET, "--dataroot", root, "--num_class",
                        str(K), "--method", "our_warp"])

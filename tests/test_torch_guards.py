"""The port's boundaries and small pieces.

* no module of the port, nor ``chip_smoke.py`` or the port's tools under
  ``tools/``, imports jax, flax or the JAX package;
* entry points default to CUDA and raise without it;
* resize, pooling and warping, metrics, data normalization and config
  against their JAX counterparts (atol 1e-5 for float math).
"""

import argparse
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2021_vspw_implement_tpu.config import cfg as jax_default_cfg
from cvpr2021_vspw_implement_tpu.data import normalize_image as jax_normalize
from cvpr2021_vspw_implement_tpu.data import remap_label as jax_remap
from cvpr2021_vspw_implement_tpu.ops import interpolate as jinterp
from cvpr2021_vspw_implement_tpu.ops import pooling as jpool
from cvpr2021_vspw_implement_tpu.ops.warp import flowwarp as jax_flowwarp
from cvpr2021_vspw_implement_tpu.utils import Evaluator as JaxEvaluator
from cvpr2021_vspw_implement_tpu.utils import get_common as jax_get_common
from cvpr2021_vspw_implement_tpu.utils import vspw_palette as jax_palette
from cvpr2021_vspw_implement_tpu_torch import tc_cal, test_clip
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.data import (normalize_image,
                                                    remap_label)
from cvpr2021_vspw_implement_tpu_torch.ops import interpolate, pooling
from cvpr2021_vspw_implement_tpu_torch.ops.warp import flowwarp
from cvpr2021_vspw_implement_tpu_torch.utils import (Evaluator, get_common,
                                                     resolve_device,
                                                     vspw_palette)
from torch_port_util import to_nchw, to_nhwc

PORT = os.path.join(os.path.dirname(__file__), os.pardir,
                    "cvpr2021_vspw_implement_tpu_torch")
FORBIDDEN = ("jax", "flax", "cvpr2021_vspw_implement_tpu")


def _port_sources():
    yield os.path.join(PORT, os.pardir, "chip_smoke.py")
    yield os.path.join(PORT, os.pardir, "tools", "torch_step_profile.py")
    yield os.path.join(PORT, os.pardir, "tools", "torch_bucket_profile.py")
    yield os.path.join(PORT, os.pardir, "tools", "torch_mma_split_bench.py")
    yield os.path.join(PORT, os.pardir, "tools", "torch_launch_bench.py")
    yield os.path.join(PORT, os.pardir, "tools", "torch_nearest_picks.py")
    yield os.path.join(PORT, os.pardir, "tools", "torch_loader_bench.py")
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_port_imports_no_jax():
    seen = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{path}: {n}"
        seen.append(os.path.relpath(path, PORT))
    # the walk did reach the trainer's modules and the kernels' wrappers
    assert {"train_clip.py", "methods.py", "models/etc.py",
            "models/decoders.py", "parallel/optim.py",
            "parallel/train_state.py", "data/loader.py", "config/args.py",
            "utils/checkpoint.py", "ops/motion_encoder.py",
            "ops/gru_flowhead.py", "ops/local_pairwise.py",
            "ops/local_agg.py", "models/warp_our.py", "models/propnet.py",
            "models/warp_our_merge.py", "ops/masked.py",
            "ops/band_zero.py", "serving.py", "bench.py", "../chip_smoke.py",
            "native/__init__.py", "test.py", "train.py", "models/builder.py",
            "models/segmentation.py", "../tools/torch_loader_bench.py",
            "../tools/torch_step_profile.py",
            "../tools/torch_bucket_profile.py",
            "../tools/torch_mma_split_bench.py", "demo.py", "vc_perclip.py",
            "data/odgt.py", "data/preprocess.py", "utils/profiling.py",
            "models/raft/flow_viz.py"} <= set(seen)


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_clip.evaluate_clip(port_default_cfg, test_clip
                                .build_eval_clip_parser().parse_args(
                                    ["--cfg", "unused"]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc_cal.main(["--dataroot", str(tmp_path), "--predroot",
                     str(tmp_path), "--allow_random_raft"])
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(13, 29), (4, 5)])
def test_resize_bilinear_matches_jax(align_corners, size):
    x = np.random.default_rng(0).normal(size=(2, 7, 11, 3)).astype(
        np.float32)
    want = np.asarray(jinterp.resize_bilinear_taps(
        jnp.asarray(x), size, align_corners=align_corners))
    got = to_nhwc(interpolate.resize_bilinear(to_nchw(x), size,
                                              align_corners=align_corners))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_resize_nearest_matches_jax():
    x = np.random.default_rng(1).normal(size=(1, 7, 11, 2)).astype(
        np.float32)
    for size in ((20, 31), (3, 4)):
        want = np.asarray(jinterp.resize_nearest(jnp.asarray(x), size))
        got = to_nhwc(interpolate.resize_nearest(to_nchw(x), size))
        np.testing.assert_array_equal(got, want)


def test_pooling_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 13, 17, 4)).astype(
        np.float32)
    for s in (1, 2, 3, 6):
        np.testing.assert_allclose(
            to_nhwc(pooling.adaptive_avg_pool2d(to_nchw(x), s)),
            np.asarray(jpool.adaptive_avg_pool2d(jnp.asarray(x), s)),
            atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        to_nhwc(pooling.global_avg_pool(to_nchw(x))),
        np.asarray(jpool.global_avg_pool(jnp.asarray(x))), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        to_nhwc(pooling.max_pool_3x3_s2_p1(to_nchw(x))),
        np.asarray(jpool.max_pool_3x3_s2_p1(jnp.asarray(x))))


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_flowwarp_matches_jax(mode):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 5, size=(1, 12, 17, 1)).astype(np.float32)
    flow = rng.normal(0, 3, size=(1, 12, 17, 2)).astype(np.float32)
    want = np.asarray(jax_flowwarp(jnp.asarray(x), jnp.asarray(flow),
                                   mode=mode))
    got = to_nhwc(flowwarp(to_nchw(x), to_nchw(flow), mode=mode))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    gts = [rng.integers(0, 4, size=(6, 9)) for _ in range(12)]
    gts[0][0, 0] = 255
    preds = [np.where(rng.random((6, 9)) < 0.8, g % 4, rng.integers(0, 4))
             for g in gts]
    mine, ref = Evaluator(4), JaxEvaluator(4)
    for g, p in zip(gts, preds):
        mine.add_batch(g[None], p[None])
        ref.add_batch(g[None], p[None])
    for name in ("Pixel_Accuracy", "Pixel_Accuracy_Class",
                 "Mean_Intersection_over_Union",
                 "Frequency_Weighted_Intersection_over_Union"):
        assert getattr(mine, name)() == getattr(ref, name)()
    np.testing.assert_array_equal(get_common(gts, preds, 3, 6, 9),
                                  jax_get_common(gts, preds, 3, 6, 9))
    assert vspw_palette() == jax_palette()


def test_data_primitives_match_jax():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, size=(7, 9, 3), dtype=np.uint8)
    np.testing.assert_array_equal(normalize_image(img), jax_normalize(img))
    mask = rng.integers(0, 256, size=(7, 9), dtype=np.uint8)
    mask[0, :3] = (0, 1, 255)
    np.testing.assert_array_equal(remap_label(mask), jax_remap(mask))


def test_preset_config_matches_jax():
    name = "vsp-resnet101dilated-ppm_deepsup_clip.yaml"
    port_cfg = port_default_cfg.clone()
    port_cfg.merge_from_file(os.path.join(PORT, "config", "presets", name))
    jcfg = jax_default_cfg.clone()
    jcfg.merge_from_file(os.path.join(
        PORT, os.pardir, "cvpr2021_vspw_implement_tpu", "config", "presets",
        name))
    for key in ("arch_encoder", "arch_decoder", "fc_dim"):
        assert port_cfg.MODEL[key] == jcfg.MODEL[key]
    assert port_cfg.DATASET.num_class == jcfg.DATASET.num_class == 124

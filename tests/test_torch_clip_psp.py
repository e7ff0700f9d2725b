"""Port TCB-PSP (ResNet-18-dilated, fc_dim 512, 5 classes, 48x64) against
the JAX ClipPSP with the same weights, window and streaming.

Logits: rtol/atol 1e-4 (f32 on both sides, a deep conv stack summed in
another order).  Predictions must be equal except at pixels whose top-2
upsampled logit gap is below 1e-4, where that order may flip the argmax.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2021_vspw_implement_tpu.config import cfg as jax_default_cfg
from cvpr2021_vspw_implement_tpu.methods import build_method
from cvpr2021_vspw_implement_tpu.models.import_torch import \
    import_clip_psp_state_dict
from cvpr2021_vspw_implement_tpu.serving import \
    ClipPSPStreamer as JaxClipPSPStreamer
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.models.clip_psp import build_clip_psp
from cvpr2021_vspw_implement_tpu_torch.ops.interpolate import resize_bilinear
from cvpr2021_vspw_implement_tpu_torch.serving import ClipPSPStreamer
from torch_port_util import (assert_trees_equal, perturb_batchnorm, to_nchw,
                             to_nhwc)

K, H, W, N = 5, 48, 64, 10
DIL = [1, 2, 3]
GAP = 1e-4


def _args(psp_weight):
    return argparse.Namespace(num_class=K, psp_weight=psp_weight,
                              deepsup_scale=0.4)


def _models(psp_weight):
    cfg = jax_default_cfg.clone()
    cfg.MODEL.arch_encoder = "resnet18dilated"
    cfg.MODEL.fc_dim = 512
    cfg.TPU.compute_dtype = "float32"
    jmodel, _ = build_method("clip_psp", cfg, _args(psp_weight))
    key = jax.random.PRNGKey(3)
    v = jmodel.init({"params": key, "dropout": key},
                    jnp.zeros((4, 1, H, W, 3), jnp.float32), train=True)
    variables = perturb_batchnorm(
        {"params": v["params"], "batch_stats": v["batch_stats"]}, seed=9)
    pcfg = port_default_cfg.clone()
    pcfg.MODEL.arch_encoder = "resnet18dilated"
    pcfg.MODEL.fc_dim = 512
    port = build_clip_psp(pcfg, K, psp_weight=psp_weight)
    return jmodel, variables, load_jax_variables(port, variables).eval()


@pytest.fixture(scope="module", params=[False, True],
                ids=["mean", "psp_weight"])
def models(request):
    return _models(request.param)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(4)
    return [rng.normal(size=(H, W, 3)).astype(np.float32) for _ in range(N)]


def test_clip_psp_logits_match_jax(models):
    jmodel, variables, port = models
    imgs = np.random.default_rng(5).normal(size=(4, 2, H, W, 3)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmodel.apply(variables, jnp.asarray(imgs),
                                       train=False)[0])
    with torch.inference_mode():
        got = port(to_nchw(imgs))[0]
    np.testing.assert_allclose(to_nhwc(got), want, rtol=1e-4, atol=1e-4)


def _window_logits(port, frames, streamer):
    """Upsampled window-forward logits [K, H, W] per frame, context order
    of the streamer, target last."""
    out = []
    with torch.inference_mode():
        for i in range(N):
            idx = streamer.context_indices(i) + [i]
            imgs = torch.stack([to_nchw(frames[k]) for k in idx])[:, None]
            out.append(resize_bilinear(port(imgs)[0], (H, W))[0])
    return out


def _assert_preds_equal_off_ties(got, want, logits):
    for g, w, lg in zip(got, want, logits):
        top2 = torch.topk(lg, 2, dim=0).values
        near_tie = (top2[0] - top2[1]).numpy() < GAP
        assert np.all((g == w) | near_tie)


def test_streamer_matches_jax_and_window(models, frames):
    jmodel, variables, port = models
    streamer = ClipPSPStreamer(port, DIL, N, (H, W), device="cpu")
    got = dict(streamer.run(frames))
    assert sorted(got) == list(range(N))
    assert all(p.dtype == np.uint8 and p.shape == (H, W)
               for p in got.values())
    with jax.default_matmul_precision("highest"):
        jstream = JaxClipPSPStreamer(jmodel, variables, DIL, N, (H, W))
        want = dict(jstream.run(frames))
    logits = _window_logits(port, frames, streamer)
    window = [torch.argmax(lg, 0).numpy().astype(np.uint8) for lg in logits]
    ordered = [got[i] for i in range(N)]
    _assert_preds_equal_off_ties(ordered, [want[i] for i in range(N)], logits)
    _assert_preds_equal_off_ties(ordered, window, logits)


def test_context_indices_match_jax(models):
    jmodel, variables, port = models
    for n in (4, 10):
        mine = ClipPSPStreamer(port, [3, 6, 9], n, (H, W), device="cpu")
        ref = JaxClipPSPStreamer(jmodel, variables, [3, 6, 9], n, (H, W))
        assert ([mine.context_indices(i) for i in range(n)]
                == [ref.context_indices(i) for i in range(n)])


def test_clip_psp_state_dict_round_trip(models):
    _, variables, port = models
    back = import_clip_psp_state_dict(port.state_dict())
    assert_trees_equal(back["params"], variables["params"])
    assert_trees_equal(back["batch_stats"], variables["batch_stats"])

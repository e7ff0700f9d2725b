"""TDNet (``tdnet``, models/td4_psp.py) of the port against the JAX package,
f32 on the CPU.

Four ResNet-18-dilated paths, 5 classes, LayerNorm maps for crop 63 (8x8)
resized to the 6x9 features of 48x72 frames (8x16 in the 64x128 bucket).
Weights are a seeded port init with BatchNorm statistics perturbed, the
LayerNorm maps live and the query and key projections scaled by 0.1
(``chip_smoke.live_td4_weights``: attention logits of a few units, not a
one-hot softmax), and the heads' biases evening out the classes' mean
logits, carried to JAX through
``import_td4_state_dict``: no JAX init of the four paths is compiled.  The
JAX CLI runs eagerly (``jax.disable_jit``: its operations compile once and
serve every path, where its jit compiles each ``pos_id`` apart) at exact
shapes, and jitted bucketed (eagerly, its masked operations made that
run 43 s on the CPU, against about 18 s jitted).  TDNet's loss curve is in tests/test_torch_train_tdnet_nl3d.py.

(a) the port's stream bucketed against its exact stream on the valid
    region over 8 frames, and the token mask is live (without it the
    bucketed logits move);
(b) ``ohem_ce_loss`` on both sides of its threshold and ``td4_loss``;
(c) the weights both ways: port → importer → ``load_jax_variables`` gives
    every tensor back, and the importer the same tree again;
(d) ``test_clip --method tdnet`` against the JAX CLI on a 10-frame video
    (every ``pos_id`` warm from the fourth frame), exact and
    ``--width_bucket 64``.  Each frame's stream step is captured on both
    sides (the JAX one by a flax method interceptor and a debug callback
    inside the CLI's step): the logits within 1e-4 of the largest
    and the K/V/Q carry within 1e-5 of its largest, frame by frame.  The
    PNGs are identical but at near-ties: the logits agree to ~5e-6 of the
    largest, and a pixel whose top-2 margin is below 1e-4 of the largest
    logit may fall either way (one such pixel of 34560 was seen); such a
    pixel is excused and counted, at most 4, and then mIoU and VC agree
    within 1e-3, else exactly;
(e) ``TD4PSP.forward`` (JAX ``train_clip``) for every ``pos_id``: main,
    sub and aux logits within 1e-4 of the largest.
"""

import argparse
import contextlib
import functools
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from cvpr2021_vspw_implement_tpu.config import cfg as jax_default_cfg
from cvpr2021_vspw_implement_tpu.models import td4_psp as jtd
from cvpr2021_vspw_implement_tpu.models.import_torch import \
    import_td4_state_dict
from cvpr2021_vspw_implement_tpu.test_clip import evaluate_clip
from cvpr2021_vspw_implement_tpu_torch import test_clip
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.data import make_synthetic_vspw
from cvpr2021_vspw_implement_tpu_torch.models import layers
from cvpr2021_vspw_implement_tpu_torch.models import td4_psp
from cvpr2021_vspw_implement_tpu_torch.ops import masked
from cvpr2021_vspw_implement_tpu_torch.ops.interpolate import resize_bilinear
from test_torch_netwarp import PRESET
from torch_port_util import (assert_trees_equal, numpy_tree,
                             perturb_port_batchnorm, to_nchw, to_nhwc)

K, H, W, CROP = 5, 48, 72, 63
PAD = (64, 128)


def _close(got, want, bar=1e-4):
    assert np.abs(got - want).max() <= bar * max(1.0, np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _models():
    """(port model in eval mode, JAX model, JAX variables)."""
    port = td4_psp.TD4PSP(K, cropsize=CROP)
    layers.init_weights(port, torch.Generator().manual_seed(0))
    perturb_port_batchnorm(port, 1)
    chip_smoke.live_td4_weights(torch, port, seed=2)
    port.eval()
    x = to_nchw(np.random.default_rng(0).normal(size=(4, 1, H, W, 3)))
    with torch.no_grad():
        for p in range(4):
            main, _, aux = port(x, pos_id=p)
            port.part("head", p).conv5[4].bias.sub_(main.mean((0, 2, 3)))
            port.part("auxlayer", p).conv5[4].bias.sub_(aux.mean((0, 2, 3)))
    variables = jax.tree_util.tree_map(
        jnp.asarray, import_td4_state_dict(port.state_dict()))
    return port, jtd.TD4PSP(num_class=K, cropsize=CROP), variables


def _frames(seed, n, h=H, w=W):
    """n frames [n, 1, h, w, 3]: a drifting random pattern plus noise."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(1, h, w, 3))
    return np.stack([np.roll(base, (i, 2 * i), (1, 2))
                     + 0.2 * rng.normal(size=base.shape)
                     for i in range(n)]).astype(np.float32)


# (a) the stream

def _port_stream(port, frames, bucketed):
    hw = PAD if bucketed else (H, W)
    state = td4_psp.init_td4_state(1, td4_psp.td4_tokens(*hw))
    outs, states = [], []
    with torch.inference_mode():
        for i, f in enumerate(frames):
            img = to_nchw(f)
            kw = {}
            if bucketed:
                img, kw = masked.pad_to(img, PAD), {"valid_hw": (H, W)}
            out, state = port.stream(img, i % 4, state, **kw)
            outs.append(out.clone())
            states.append({k: (v if k == "count" else torch.stack(v).numpy())
                           for k, v in state.items()})
    return outs, states


@functools.lru_cache(maxsize=None)
def _streams(bucketed):
    return _port_stream(_models()[0], _frames(2, 8), bucketed)


def test_bucketed_stream_equals_exact_and_reads_the_token_mask(monkeypatch):
    exact, _ = _streams(False)
    bucketed, _ = _streams(True)
    fv = masked.feature_valid(*bucketed[0].shape[-2:], (H, W), PAD)
    assert fv == tuple(exact[0].shape[-2:])
    for e, b in zip(exact, bucketed):
        _close(b[..., :fv[0], :fv[1]].numpy(), e.numpy())
    # without the token mask the padded tokens enter every warm frame's
    # attention: the check above must then fail
    monkeypatch.setattr(td4_psp, "token_valid", lambda *a: None)
    port, _, _ = _models()
    unmasked, _ = _port_stream(port, _frames(2, 8), True)
    moved = max((u[..., :fv[0], :fv[1]] - e).abs().max().item()
                for u, e in zip(unmasked[3:], exact[3:]))
    assert moved > 1e-2 * max(e.abs().max().item() for e in exact)


# (b) the losses

@pytest.mark.parametrize("hard_share", [1.0, 0.03])
def test_ohem_and_td4_loss_match_jax(hard_share):
    """OHEM on both sides of its threshold: every pixel hard (the mean of
    those above it), and 3% hard (the n_min-th is below it: the top-n_min
    mean)."""
    rng = np.random.default_rng(3)
    b, h, w = 2, 24, 40
    lab = rng.integers(0, K, (4, b, h, w)).astype(np.int32)
    lab[:, :, 0, :7] = 255
    logits = rng.normal(size=(b, h, w, K)).astype(np.float32)
    easy = rng.random((b, h, w)) >= hard_share
    logits += 12.0 * (easy[..., None] & (np.arange(K) == lab[-1][..., None]))
    n_min = b * h * w // 16
    want = jtd.ohem_ce_loss(jnp.asarray(logits), jnp.asarray(lab[-1]), n_min)
    got = td4_psp.ohem_ce_loss(to_nchw(logits), torch.from_numpy(lab[-1]),
                               n_min)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    outs = [rng.normal(size=(b, 6, 10, K)).astype(np.float32)
            for _ in range(3)]
    jl, ja = jtd.td4_loss([jnp.asarray(o) for o in outs],
                          {"labels": jnp.asarray(lab)})
    pl, pa = td4_psp.td4_loss([to_nchw(o) for o in outs],
                              {"labels": torch.from_numpy(lab).long()})
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-5)
    assert pa.item() == pytest.approx(float(ja), abs=1e-6)


# (c) the weights

def test_weights_round_trip():
    port, _, variables = _models()
    back = load_jax_variables(td4_psp.TD4PSP(K, cropsize=CROP),
                              numpy_tree(variables))
    want, got = port.state_dict(), back.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    again = numpy_tree(import_td4_state_dict(got))
    assert_trees_equal(again["params"], numpy_tree(variables["params"]))
    assert_trees_equal(again["batch_stats"],
                       numpy_tree(variables["batch_stats"]))


# (d) the CLI

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tdnet") / "vspw")
    make_synthetic_vspw(root, 1, 10, (H, W), K, seed=7)
    return root


def _jax_stream_records(records):
    """A flax interceptor that hands each ``TD4PSP.stream`` step's logits
    and next carry to ``records`` (a debug callback, so from inside the
    CLI's jit)."""
    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if (isinstance(context.module, jtd.TD4PSP)
                and context.method_name == "stream"):
            jax.debug.callback(lambda o, st: records.append(
                (np.asarray(o), {k: np.asarray(v) for k, v in st.items()})),
                *out)
        return out
    return interceptor


def _port_stream_records(records, monkeypatch):
    stream = td4_psp.TD4PSP.stream

    def recorded(self, *args, **kwargs):
        out, state = stream(self, *args, **kwargs)
        records.append((out.clone(), {k: (v if k == "count" else
                                          torch.stack(v).numpy())
                                      for k, v in state.items()}))
        return out, state
    monkeypatch.setattr(td4_psp.TD4PSP, "stream", recorded)


def _upsampled(logits, bucket):
    if not bucket:
        return resize_bilinear(logits, (H, W), align_corners=True)[0]
    fv = masked.feature_valid(*logits.shape[-2:], (H, W), PAD)
    return masked.resize_bilinear_rt(logits, PAD, fv, (H, W),
                                     align_corners=True)[0, :, :H, :W]


@pytest.mark.parametrize("bucket", [0, 64])
def test_cli_matches_jax(root, tmp_path, bucket, monkeypatch):
    port, _, variables = _models()
    cfg = jax_default_cfg.clone()
    cfg.TPU.compute_dtype = "float32"
    args = argparse.Namespace(
        method="tdnet", num_class=K, cropsize=CROP, dataroot=root,
        split="val", vc_clip_num=8, lesslabel=False, load="", is_save=True,
        saveroot=str(tmp_path / "jax"), width_bucket=bucket,
        eval_policy="bucketed", clip_num=4, dilation_num=0,
        dilation2="3,6,9")
    want = []
    with (contextlib.nullcontext() if bucket else jax.disable_jit()), \
            flax.linen.intercept_methods(_jax_stream_records(want)):
        jm, _ = evaluate_clip(cfg, args, variables=variables, is_save=True)
    ckpt = str(tmp_path / "model.pth")
    torch.save(port.state_dict(), ckpt)
    got = []
    _port_stream_records(got, monkeypatch)
    pm, _ = test_clip.main([
        "--cfg", PRESET, "--dataroot", root, "--num_class", str(K),
        "--method", "tdnet", "--cropsize", str(CROP), "--width_bucket",
        str(bucket), "--load", ckpt, "--is_save", "--saveroot",
        str(tmp_path / "port"), "--device", "cpu"])
    assert len(got) == len(want) == 10
    for i, ((g, gs), (w, ws)) in enumerate(zip(got, want)):
        _close(to_nhwc(g), w)
        assert gs["count"] == int(ws["count"]) == min(i + 1, 3)
        for k in ("K", "V", "Q"):
            _close(gs[k], ws[k], 1e-5)
    assert pm["buckets"] == ([PAD] if bucket else [])
    # the PNGs, near-ties excused
    jdir = tmp_path / "jax" / "video_000"
    pdir = tmp_path / "port" / "video_000"
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names and len(names) == 10
    scale = max(np.abs(w).max() for w, _ in want)
    classes, differ, excused = set(), 0, 0
    for name, (g, _) in zip(names, got):
        a = np.asarray(Image.open(jdir / name))
        b = np.asarray(Image.open(pdir / name))
        top = _upsampled(g, bucket).topk(2, dim=0).values
        near = ((top[0] - top[1]) < 1e-4 * scale).numpy()
        differ += int((a != b).sum())
        excused += int(((a != b) & near).sum())
        classes |= set(np.unique(a).tolist())
    print(f"\ntdnet CLI, bucket {bucket}: PNGs differ at {differ} pixels, "
          f"{excused} of them near-ties; mIoU {pm['mIoU']} (JAX "
          f"{jm['mIoU']}), VC {pm['VC']} (JAX {jm['VC']})")
    assert len(classes) > 1, "the predictions hold one class"
    assert differ == excused <= 4
    bar = 1e-3 if differ else 1e-12
    assert pm["mIoU"] == pytest.approx(jm["mIoU"], abs=bar)
    assert pm["VC"] == pytest.approx(jm["VC"], abs=bar)


# (e) the training forward, last: it reuses the eager operations that the
# exact CLI compiled

@pytest.mark.parametrize("pos_id", [0, 1, 2, 3])
def test_train_clip_matches_jax(pos_id):
    port, jmodel, variables = _models()
    x = _frames(1, 4)
    with jax.disable_jit():
        want = jmodel.apply(variables, jnp.asarray(x), pos_id=pos_id,
                            train=False)
    with torch.no_grad():
        got = port(to_nchw(x), pos_id=pos_id)
    assert len(got) == 3
    for g, w in zip(got, want):
        _close(to_nhwc(g), np.asarray(w))

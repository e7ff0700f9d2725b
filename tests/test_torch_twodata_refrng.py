"""The training datasets' two-dataset and reference-RNG modes, the odgt
dataset, and ``--usetwodata`` / ``--refrng`` through the trainers, against
the JAX package.

Items are held bitwise against JAX's from the same seeds: ``TwoDataset``
(its secondary index from its own stateful ``default_rng(seed)``),
``OdgtDataset`` (train and val), and the ``--refrng`` items of
``FrameDataset`` (with and without ``--multi_scale``), ``ClipDataset`` and
``LongClipDataset``, drawn in sequence after seeding the global ``random``
and ``np.random`` streams.  The ``--usetwodata`` loss curve of the
per-frame trainer (ResNet-18-dilated + C1, batch 8 of each dataset, JAX's
init carried into the port) within rtol 1e-2 of JAX ``train.train``, the
JAX package's curve-parity bar.  ``train_clip --refrng true`` runs and
draws from the global streams.
"""

import argparse
import json
import os
import random
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from cvpr2021_vspw_implement_tpu import train as jax_train
from cvpr2021_vspw_implement_tpu.config import cfg as jax_default_cfg
from cvpr2021_vspw_implement_tpu.data import datasets as jax_datasets
from cvpr2021_vspw_implement_tpu.data.odgt import OdgtDataset as JaxOdgt
from cvpr2021_vspw_implement_tpu.models import import_torch as jimport
from cvpr2021_vspw_implement_tpu_torch import test as port_test
from cvpr2021_vspw_implement_tpu_torch import train as port_train
from cvpr2021_vspw_implement_tpu_torch import train_clip as port_train_clip
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.data import (ClipDataset,
                                                    FrameDataset,
                                                    LongClipDataset,
                                                    OdgtDataset, TwoDataset,
                                                    make_synthetic_vspw)
from test_torch_cli_tools import JittedInit
from torch_port_util import numpy_tree

K = 5
PRESETS = os.path.join(os.path.dirname(port_train.__file__), "config",
                       "presets")


@pytest.fixture(autouse=True)
def drop_checkpoints(tmp_path):
    """Each test's checkpoints (~100-200 MB a file) go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """A VSPW root of 24 one-frame videos and a second root of 6 videos of
    2 frames, 48x64."""
    tmp = tmp_path_factory.mktemp("twodata")
    first, second = str(tmp / "a"), str(tmp / "b")
    make_synthetic_vspw(first, 24, 1, (48, 64), K, seed=31)
    make_synthetic_vspw(second, 6, 2, (48, 64), K, seed=32)
    return first, second


@pytest.fixture(scope="module")
def clip_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("refrng_clips"))
    make_synthetic_vspw(root, 2, 12, (40, 48), K, seed=33)
    return root


def _args(**kw):
    base = dict(trainfps=15, cropsize=32, multi_scale=False,
                lesslabel=False, train_filter=False, refrng=False,
                clip_num=4, dilation_num=1, dilation2="2,3,5")
    base.update(kw)
    return argparse.Namespace(**base)


def _assert_items_equal(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_items_equal(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("multi_scale", [False, True])
def test_two_dataset_items_match_jax(roots, multi_scale):
    args = _args(dataroot=roots[0], dataroot2=roots[1],
                 multi_scale=multi_scale)
    port, jax_ds = TwoDataset(args, seed=3), jax_datasets.TwoDataset(args,
                                                                     seed=3)
    assert len(port) == len(jax_ds) == 24 and len(port.secondary) == 12
    assert not hasattr(port, "set_epoch")
    seconds = set()
    for idx in (4, 0, 23, 4, 7, 2):
        got, want = port[idx], jax_ds[idx]
        _assert_items_equal(got, want)
        seconds.add(got[1][1].tobytes())
    assert len(seconds) > 1     # the secondary draw moves


@pytest.fixture(scope="module")
def odgt_root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("odgt")
    rng = np.random.default_rng(0)
    records = []
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (37, 51, 3), np.uint8)).save(
            tmp / f"img{i}.jpg")
        Image.fromarray(rng.integers(0, 6, (37, 51), np.uint8)).save(
            tmp / f"seg{i}.png")
        records.append({"fpath_img": f"img{i}.jpg",
                        "fpath_segm": f"seg{i}.png", "width": 51,
                        "height": 37})
    odgt = tmp / "train.odgt"
    odgt.write_text("\n".join(json.dumps(r) for r in records))
    return str(tmp), str(odgt)


@pytest.mark.parametrize("split", ["train", "val"])
def test_odgt_items_match_jax(odgt_root, split):
    root, odgt = odgt_root
    opt = argparse.Namespace(imgSizes=(40, 48, 56), imgMaxSize=100,
                             padding_constant=8, segm_downsampling_rate=4,
                             random_flip=True)
    port = OdgtDataset(root, odgt, opt, split, seed=5)
    jax_ds = JaxOdgt(root, odgt, opt, split, seed=5)
    sizes = set()
    for idx in (0, 2, 1, 0, 2, 1, 0):
        got, want = port[idx], jax_ds[idx]
        _assert_items_equal(got, want)
        sizes.add(got[0].shape)
    assert (len(sizes) > 1) == (split == "train")


REFRNG_CASES = {
    "frame": (FrameDataset, jax_datasets.FrameDataset, {}),
    "frame_multiscale": (FrameDataset, jax_datasets.FrameDataset,
                         {"multi_scale": True}),
    "clip": (ClipDataset, jax_datasets.ClipDataset, {"multi_scale": True}),
    "longclip": (LongClipDataset, jax_datasets.LongClipDataset, {}),
}


def _seed_globals(s):
    np.random.seed(s)
    random.seed(s)


@pytest.mark.parametrize("case", sorted(REFRNG_CASES))
def test_refrng_items_match_jax(clip_root, case):
    """Eight items in a row from the global streams seeded alike: the
    port's equal JAX's bitwise, and the streams end in the same state; the
    same items without ``--refrng`` leave the streams alone."""
    port_cls, jax_cls, kw = REFRNG_CASES[case]
    args = _args(dataroot=clip_root, refrng=True, **kw)
    port, jax_ds = port_cls(args, "train", seed=1), jax_cls(args, "train",
                                                          seed=1)
    order = [i % len(port) for i in (5, 1, 0, 3, 1, 2, 7, 4)]
    _seed_globals(11)
    got = [port[i] for i in order]
    after = (np.random.get_state()[1].copy(), random.getstate())
    _seed_globals(11)
    want = [jax_ds[i] for i in order]
    _assert_items_equal(got, want)
    np.testing.assert_array_equal(after[0], np.random.get_state()[1])
    assert after[1] == random.getstate()
    _seed_globals(11)
    seeded = (np.random.get_state()[1].copy(), random.getstate())
    assert seeded[1] != after[1]
    own = port_cls(_args(dataroot=clip_root, **kw), "train", seed=1)
    for i in order:
        own[i]
    np.testing.assert_array_equal(np.random.get_state()[1], seeded[0])
    assert random.getstate() == seeded[1]


def test_usetwodata_curve_matches_jax(roots, tmp_path, monkeypatch):
    """``--usetwodata``: 3 steps of 8 + 8 frames, the losses within rtol
    1e-2 of JAX's trainer on the same batches and init (at 4 + 4 the third
    step's losses part by 5.9e-3: small batches make the f32 gradients
    ill-conditioned, tests/test_torch_train_frame.py)."""
    jcfg = jax_default_cfg.clone()
    jcfg.MODEL.arch_encoder = "resnet18dilated"
    jcfg.MODEL.arch_decoder = "c1"
    jcfg.MODEL.fc_dim = 512
    jcfg.TPU.compute_dtype = "float32"
    jcfg.TPU.remat = False
    jcfg.DIR = str(tmp_path / "jax_ckpt")
    args = argparse.Namespace(
        dataroot=roots[0], dataroot2=roots[1], usetwodata=True,
        use_clipdataset=False, trainfps=15, cropsize=48, multi_scale=True,
        lesslabel=False, train_filter=False, batchsize=8, lr=0.01,
        totalepoch=1, num_class=K, weight_decay=1e-4, workers=0,
        saveroot="", resume=False, use_float16=False, refrng=False,
        profile_dir="", device="cpu", seed=None)
    caught, jax_losses, port_losses = [], [], []

    def catch_init(variables, *a, **kw):
        caught.append(numpy_tree(variables))
        return variables

    monkeypatch.setattr(jimport, "apply_pretrained_init", catch_init)
    make_step = jax_train.make_train_step

    def recording_make_step(*a, **kw):
        step = make_step(*a, **kw)

        def recorded(state, batch, rng):
            assert batch["img"].shape[0] == 16
            state, metrics = step(state, batch, rng)
            jax_losses.append(float(metrics["loss"]))
            return state, metrics
        return recorded

    monkeypatch.setattr(jax_train, "make_train_step", recording_make_step)
    build = jax_train.build_model
    monkeypatch.setattr(jax_train, "build_model",
                        lambda *a: JittedInit(build(*a)))
    step = port_train.train_step

    def recorded_port(model, optimizer, scheduler, batch, loss_fn):
        assert batch["img"].shape[0] == 16
        metrics = step(model, optimizer, scheduler, batch, loss_fn)
        port_losses.append(metrics["loss"].item())
        return metrics

    monkeypatch.setattr(port_train, "train_step", recorded_port)
    with jax.default_matmul_precision("highest"):
        jax_train.train(jcfg, args)

    pcfg = port_default_cfg.clone()
    pcfg.MODEL.arch_encoder = "resnet18dilated"
    pcfg.MODEL.arch_decoder = "c1"
    pcfg.MODEL.fc_dim = 512
    pcfg.DIR = str(tmp_path / "port_ckpt")
    port = load_jax_variables(port_test.build_segmentation(pcfg, K),
                              caught[0])
    enc, dec = str(tmp_path / "enc.pth"), str(tmp_path / "dec.pth")
    torch.save(port.encoder.state_dict(), enc)
    torch.save(port.decoder.state_dict(), dec)
    pcfg.MODEL.weights_encoder, pcfg.MODEL.weights_decoder = enc, dec
    port_train.train(pcfg, args)
    got, want = np.array(port_losses), np.array(jax_losses)
    print(f"\n--usetwodata: port losses {got}, JAX losses {want}, max "
          f"relative difference {np.max(np.abs(got - want) / want):.2e}")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-2)
    assert np.ptp(want) > 1e-3 * want[0]


def test_train_clip_refrng_runs(clip_root, tmp_path):
    """``train_clip --refrng true`` (clip_psp, one step) draws its clips
    from the global streams, which ``main`` seeds; without the flag they
    stay as seeded."""
    def run(flag):
        port_train_clip.main([
            "--cfg", os.path.join(
                PRESETS, "vsp-resnet18dilated-ppm_deepsup_clip.yaml"),
            "--dataroot", clip_root, "--num_class", str(K), "--method",
            "clip_psp", "--clip_num", "4", "--dilation2", "2,3,5",
            "--batchsize", "2", "--cropsize", "32", "--totalepoch", "1",
            "--refrng", flag, "--device", "cpu", "--validation", "false",
            "--saveroot", str(tmp_path / flag), "DIR",
            str(tmp_path / flag)])
        return np.random.get_state()[1].copy(), random.getstate()

    random.seed(0)
    seeded_py = random.getstate()
    np.random.seed(port_default_cfg.TRAIN.seed)
    seeded_np = np.random.get_state()[1].copy()
    random.seed(0)
    drew_np, drew_py = run("true")
    assert not np.array_equal(drew_np, seeded_np)
    assert drew_py != seeded_py
    random.seed(0)
    kept_np, kept_py = run("false")
    np.testing.assert_array_equal(kept_np, seeded_np)
    assert kept_py == seeded_py

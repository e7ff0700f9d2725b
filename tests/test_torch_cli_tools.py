"""The port's small CLI tools against the JAX package's: ``vc_perclip``,
``demo`` (RAFT flow PNGs) and ``data/preprocess``
(tests/test_torch_fused_load.py holds ``test_clip --torch_load``).

* ``vc_perclip``: the VC score equal to JAX ``compute_vc`` within 1e-12;
* ``demo``: three 45x61 frames (two pairs, /8-padded to 48x64), RAFT at 3
  refinements with the port's seeded init (BatchNorm perturbed, the flow
  head scaled to a trained-like step as tests/test_torch_raft.py scales
  it), through both CLIs on one saved ``.pth``: the flows within 1e-3 px,
  and the flow PNGs equal but at near-ties, pixels whose colour before
  the floor lies within 1e-3 of an integer: one pixel here (164.0001);
* ``data/preprocess``: the 480p tree of a synthetic VSPW tree, every file
  byte-identical to the JAX tool's.
"""

import filecmp
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from cvpr2021_vspw_implement_tpu import demo as jax_demo
from cvpr2021_vspw_implement_tpu import vc_perclip as jax_vc
from cvpr2021_vspw_implement_tpu.data import preprocess as jax_preprocess
from cvpr2021_vspw_implement_tpu_torch import demo, vc_perclip
from cvpr2021_vspw_implement_tpu_torch.data import make_synthetic_vspw
from cvpr2021_vspw_implement_tpu_torch.data import preprocess
from cvpr2021_vspw_implement_tpu_torch.models.layers import init_weights
from cvpr2021_vspw_implement_tpu_torch.models.raft import RAFT
from cvpr2021_vspw_implement_tpu_torch.models.raft.flow_viz import \
    make_colorwheel
from torch_port_util import perturb_port_batchnorm

K = 5
ITERS = 3
#: a flow PNG pixel may differ by one level where JAX's colour before the
#: floor lies this close to an integer (a near-tie)
TIE = 1e-3


class JittedInit:
    """A Flax model whose ``init`` is jitted: eager, the init of a ResNet
    or RAFT runs op by op for 20-30 s on a CPU, jitted for a few.  Every
    other attribute is the model's.  For comparisons where loaded weights
    overwrite what ``init`` makes (tests/test_torch_fused_load.py and
    tests/test_torch_twodata_refrng.py import it)."""

    def __init__(self, model):
        self.model = model

    def __getattr__(self, name):
        return getattr(self.model, name)

    def init(self, rngs, *args, **kw):
        return jax.jit(lambda r, *x: self.model.init(r, *x, **kw))(rngs,
                                                                   *args)


@pytest.fixture(autouse=True)
def drop_checkpoints(tmp_path):
    """Each test's checkpoints (~100-200 MB a file) go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("cli_tools") / "vspw")
    make_synthetic_vspw(r, 1, 10, (48, 64), K, seed=41)
    return r


def test_vc_perclip_matches_jax(root, tmp_path):
    """Predictions: the masks with 3% of the pixels set at random."""
    rng = np.random.default_rng(0)
    mdir = os.path.join(root, "data", "video_000", "mask")
    os.makedirs(tmp_path / "video_000")
    for name in sorted(os.listdir(mdir)):
        mask = np.asarray(Image.open(os.path.join(mdir, name))).copy()
        flip = rng.random(mask.shape) < 0.03
        mask[flip] = rng.integers(0, K, flip.sum())
        Image.fromarray(mask).save(tmp_path / "video_000" / name)
    argv = ["--dataroot", root, "--predroot", str(tmp_path), "--clip_num",
            "8"]
    got = vc_perclip.main(argv)
    want = jax_vc.compute_vc(jax_vc.build_parser().parse_args(argv))
    assert 0.5 < got < 1
    assert abs(got - want) <= 1e-12


def colour_levels(flow):
    """``flow_to_image(flow)`` before its floor: 255 x the colour."""
    u, v = flow[..., 0].astype(np.float64), flow[..., 1].astype(np.float64)
    rad_max = max(np.sqrt(u ** 2 + v ** 2).max(), 1e-5)
    u, v = u / rad_max, v / rad_max
    rad = np.sqrt(u ** 2 + v ** 2)
    wheel = make_colorwheel()
    fk = (np.arctan2(-v, -u) / np.pi + 1) / 2 * (len(wheel) - 1)
    k0 = np.floor(fk).astype(int)
    f = fk - k0
    out = np.empty((*u.shape, 3))
    for c in range(3):
        col0 = wheel[k0, c] / 255.0
        col1 = wheel[(k0 + 1) % len(wheel), c] / 255.0
        col = (1 - f) * col0 + f * col1
        out[..., c] = 255 * np.where(rad <= 1, 1 - rad * (1 - col),
                                     col * 0.75)
    return out


def test_demo_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    frames = tmp_path / "frames"
    os.makedirs(frames)
    im = rng.uniform(0, 255, (45, 61, 3))
    for t in range(3):
        noisy = np.roll(im, (t, 2 * t), axis=(0, 1)) + rng.normal(0, 4,
                                                                  im.shape)
        Image.fromarray(np.clip(noisy, 0, 255).astype(np.uint8)).save(
            frames / f"{t:05d}.png")

    port = RAFT(iters=ITERS)
    init_weights(port, torch.Generator().manual_seed(5))
    perturb_port_batchnorm(port, seed=5)
    with torch.no_grad():
        port.update_block.flow_head.conv2.weight.mul_(0.1)
    ckpt = str(tmp_path / "raft.pth")
    torch.save(port.state_dict(), ckpt)

    # the checkpoint overwrites every value of JAX's RAFT init
    load = jax_demo.load_raft_variables
    monkeypatch.setattr(jax_demo, "load_raft_variables",
                        lambda path, model: load(path, JittedInit(model)))
    jax_flows = []
    flow_to_image = jax_demo.flow_to_image

    def caught(flow, *a, **kw):
        jax_flows.append(np.array(flow))
        return flow_to_image(flow, *a, **kw)

    monkeypatch.setattr(jax_demo, "flow_to_image", caught)
    monkeypatch.setattr(sys, "argv", [
        "demo", "--path", str(frames), "--out", str(tmp_path / "jax"),
        "--raft_ckpt", ckpt, "--iters", str(ITERS)])
    with jax.default_matmul_precision("highest"):
        jax_demo.main()
    flows = demo.main(["--path", str(frames), "--out", str(tmp_path / "port"),
                       "--raft_ckpt", ckpt, "--iters", str(ITERS),
                       "--device", "cpu"])

    assert len(flows) == len(jax_flows) == 2
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "00000_flow.png", "00001_flow.png"]
    ties = 0
    for got, want, name in zip(flows, jax_flows, names):
        assert got.shape == want.shape == (45, 61, 2)
        gap = np.abs(got - want).max()
        assert gap <= 1e-3, gap
        assert np.abs(want).max() > 0.5     # the flow is not nothing
        a = np.asarray(Image.open(tmp_path / "port" / name))
        b = np.asarray(Image.open(tmp_path / "jax" / name))
        differ = a != b
        level = colour_levels(want)
        print(f"\ndemo {name}: flow gap {gap:.2e} px; PNG pixels that "
              f"differ {int(differ.any(-1).sum())}, their colours "
              f"{level[differ]} before the floor")
        assert np.abs(a.astype(int) - b).max() <= 1
        assert (np.abs(level - np.round(level))[differ] < TIE).all()
        ties += int(differ.any(-1).sum())
    assert ties == 1


def test_preprocess_matches_jax(tmp_path, monkeypatch):
    src = str(tmp_path / "src")
    make_synthetic_vspw(src, 2, 3, (60, 100), K, seed=43)
    os.remove(os.path.join(src, "data", "video_001", "mask", "00000002.png"))
    monkeypatch.setattr(sys, "argv", ["preprocess", src,
                                      str(tmp_path / "jax")])
    jax_preprocess.main()
    preprocess.main([src, str(tmp_path / "port"), "--workers", "2"])

    def tree(top):
        return sorted(os.path.relpath(os.path.join(d, f), top)
                      for d, _, files in os.walk(top) for f in files)

    files = tree(tmp_path / "jax")
    assert files == tree(tmp_path / "port")
    assert len(files) == 6 + 5 + 2
    _, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "jax", tmp_path / "port", files, shallow=False)
    assert not mismatch and not errors
    assert Image.open(tmp_path / "port" / "data" / "video_000" / "origin" /
                      "00000000.jpg").size == (800, 480)

"""The per-frame trainer's preemption, ``--resume`` and ``--profile_dir``.

ResNet-18-dilated + ``ppm_deepsup`` (its two ``Dropout2d``), 5 classes, 8
frames of 40x40 scaled and cropped to 32 with ``--multi_scale``, batch 2:
two epochs of 4 steps.  A run preempted by a real SIGTERM during its 6th
step saves ``preempt_6.pth`` at that step's end and returns; resumed, it
ends in the uninterrupted run's state bitwise: parameters, BatchNorm
statistics, momentum, the scheduler's position, the dropout generator, and
the dropout draws and losses of steps 7 and 8.  Where the resumed run
starts (epoch, step, skipped batches) is held against JAX ``train.train``
on the same sequence of saves; JAX's model is one conv and its step one
that only counts (the position depends on the saves alone).
"""

import argparse
import logging
import os
import re
import shutil
import signal
import threading

import flax.linen as fnn
import jax.numpy as jnp
import pytest
import torch

from cvpr2021_vspw_implement_tpu import train as jax_train
from cvpr2021_vspw_implement_tpu.config import cfg as jax_default_cfg
from cvpr2021_vspw_implement_tpu.utils import checkpoint as jax_ckpt
from cvpr2021_vspw_implement_tpu_torch import train as port_train
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.data import (PrefetchLoader,
                                                    TwoDataset,
                                                    collate_two_frames,
                                                    make_synthetic_vspw)
from cvpr2021_vspw_implement_tpu_torch.utils import checkpoint
import torch_port_util  # noqa: F401  (it caps torch's threads)

K = 5
PRESET = os.path.join(os.path.dirname(port_train.__file__), "config",
                      "presets", "vsp-resnet18dilated-ppm_deepsup.yaml")
RESUMED = re.compile(r"resumed from \S+ \(epoch (\d+), step (\d+), "
                     r"skipping (\d+) batches\)")


@pytest.fixture(autouse=True)
def drop_checkpoints(tmp_path):
    """Each test's checkpoints (~200 MB a file) go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("vspw_resume"))
    make_synthetic_vspw(r, 1, 8, (40, 40), K, seed=23)
    return r


def _cfg(ckpt_dir):
    cfg = port_default_cfg.clone()
    cfg.merge_from_file(PRESET)
    cfg.DIR = str(ckpt_dir)
    cfg.TRAIN.epoch_iters = 4
    return cfg


def _args(root, **kw):
    base = dict(dataroot=root, num_class=K, batchsize=2, cropsize=32,
                trainfps=15, multi_scale=True, lr=0.01, totalepoch=2,
                weight_decay=1e-4, lesslabel=False, train_filter=False,
                use_clipdataset=False, usetwodata=False, resume=False,
                use_float16=False, refrng=False, profile_dir="",
                device="cpu", seed=None)
    base.update(kw)
    return argparse.Namespace(**base)


class Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logger(name):
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    logger.handlers = [Lines()]
    return logger


def resumed_at(logger):
    """(epoch, step, skipped batches) of the trainer's 'resumed from' line."""
    found = [RESUMED.search(m) for m in logger.handlers[0].lines]
    return [tuple(int(g) for g in m.groups()) for m in found if m]


def run_port(cfg, args, preempt_at=None, logger=None, max_steps=None):
    """``port_train.train``, recording each step's loss, dropout draws
    (every ``torch.rand`` of the step) and images; with ``preempt_at`` the
    process sends itself SIGTERM inside that step.  Returns (model,
    steps)."""
    steps = []
    step, rand = port_train.train_step, torch.rand

    def recorded(*a, **kw):
        draws = []

        def rand_recorded(*ra, **rkw):
            out = rand(*ra, **rkw)
            draws.append(out.clone())
            return out

        torch.rand = rand_recorded
        try:
            metrics = step(*a, **kw)
        finally:
            torch.rand = rand
        steps.append((metrics["loss"].item(), draws, a[3]["img"].clone()))
        if len(steps) == preempt_at:
            handler = signal.getsignal(signal.SIGTERM)
            assert isinstance(getattr(handler, "__self__", None),
                              checkpoint.PreemptionCheckpointer)
            os.kill(os.getpid(), signal.SIGTERM)
        return metrics

    port_train.train_step = recorded
    try:
        model = port_train.train(cfg, args, logger or _logger("port"),
                                 max_steps=max_steps)
    finally:
        port_train.train_step = step
    return model, steps


@pytest.fixture(scope="module")
def runs(root, tmp_path_factory):
    """The uninterrupted run, traced with ``--profile_dir``, and the run
    preempted in step 6 then resumed, untraced, each with its steps."""
    base = tmp_path_factory.mktemp("resume_runs")
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers need the main thread")
    ref_dir, pre_dir, prof = base / "ref", base / "pre", base / "prof"
    _, ref_steps = run_port(_cfg(ref_dir), _args(root, profile_dir=str(prof)))
    traces = {name: (prof / name).read_text() for name in os.listdir(prof)}
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    _, killed = run_port(_cfg(pre_dir), _args(root), preempt_at=6)
    after_kill = {s: signal.getsignal(s) for s in handlers}
    files_after_kill = sorted(os.listdir(pre_dir))
    preempt = {k: v for k, v in torch.load(
        pre_dir / "preempt_6.pth", map_location="cpu").items()
        if k in ("step", "epoch", "scheduler")}
    logger = _logger("port_resume")
    _, resumed = run_port(_cfg(pre_dir), _args(root, resume=True),
                          logger=logger)
    finals = [torch.load(d / "model_epoch_2.pth", map_location="cpu")
              for d in (ref_dir, pre_dir)]
    # the checkpoints take ~200 MB each: the runs' directories go
    shutil.rmtree(base)
    return dict(ref_steps=ref_steps, killed=killed, resumed=resumed,
                handlers=handlers, after_kill=after_kill,
                files_after_kill=files_after_kill, preempt=preempt,
                finals=finals, resumed_at=resumed_at(logger), traces=traces)


def _assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def test_preemption_saves_at_the_step_boundary(runs):
    """SIGTERM in step 6: ``preempt_6.pth`` holds step 6 of epoch 1, the
    first epoch's checkpoint is there, the loop returned after 6 steps,
    the signal handlers are the original ones again and the loader's
    worker thread is gone."""
    assert len(runs["killed"]) == 6
    assert runs["files_after_kill"] == ["model_epoch_1.pth",
                                        "preempt_6.pth"]
    saved = runs["preempt"]
    assert (saved["step"], saved["epoch"]) == (6, 1)
    assert saved["scheduler"]["last_epoch"] == 6
    assert runs["after_kill"] == runs["handlers"]
    assert not [t for t in threading.enumerate()
                if t.name == "PrefetchLoader"]


def test_resume_matches_uninterrupted_bitwise(runs):
    """The resumed run's steps 7-8 (losses, dropout draws) and its final
    checkpoint (model with BatchNorm statistics, optimizer momentum,
    scheduler, dropout generator, step, epoch) bitwise the uninterrupted
    run's."""
    assert runs["resumed_at"] == [(1, 6, 2)]
    assert len(runs["ref_steps"]) == 8 and len(runs["resumed"]) == 2
    for got, want in zip(runs["killed"] + runs["resumed"],
                         runs["ref_steps"]):
        assert got[0] == want[0]
        _assert_same(got[1:], want[1:], "dropout draws, images")
    assert all(len(d) == 2 for _, d, _ in runs["ref_steps"])
    ref, res = runs["finals"]
    assert ref["optimizer"]["state"], "no momentum saved"
    assert ref["dropout_rng"] is not None
    _assert_same(res, ref)


class FakePreempt:
    """JAX's checkpointer that trips after step ``at`` (its
    tests/test_resume.py)."""

    at = 6

    def __init__(self, ckpt_dir, prefix="preempt_"):
        self.ckpt_dir, self.prefix, self.calls = ckpt_dir, prefix, 0

    @property
    def requested(self):
        self.calls += 1
        return self.calls >= self.at

    def maybe_save(self, state, step):
        return jax_ckpt.save_checkpoint(self.ckpt_dir, state, step,
                                        prefix=self.prefix)


class OneConv(fnn.Module):
    """JAX's model here: where the run resumes depends on its saves, not
    on what it trains."""

    @fnn.compact
    def __call__(self, x, train=False):
        return fnn.Conv(4, (3, 3))(x)


def _jax_resumed_at(root, ckpt_dir, at, monkeypatch):
    cfg = jax_default_cfg.clone()
    cfg.DIR = str(ckpt_dir)
    cfg.TRAIN.epoch_iters = 4
    cfg.TPU.compute_dtype = "float32"
    cfg.TPU.remat = False

    def counting_step(model, tx, **kw):
        def step(state, batch, key):
            return state.replace(step=state.step + 1), {
                "loss": jnp.zeros(()), "acc": jnp.zeros(())}
        return step

    def args(resume):
        return argparse.Namespace(
            dataroot=root, trainfps=15, cropsize=32, multi_scale=False,
            lesslabel=False, train_filter=False, batchsize=2, lr=0.01,
            totalepoch=2, num_class=K, weight_decay=1e-4, workers=0,
            saveroot="", use_clipdataset=False, usetwodata=False,
            resume=resume)

    monkeypatch.setattr(jax_train, "build_model", lambda *a: OneConv())
    monkeypatch.setattr(jax_train, "make_train_step", counting_step)
    monkeypatch.setattr(FakePreempt, "at", at)
    monkeypatch.setattr(jax_ckpt, "PreemptionCheckpointer", FakePreempt)
    killed = jax_train.train(cfg, args(False), _logger("jax"))
    assert int(killed.step) == at
    monkeypatch.setattr(FakePreempt, "at", 10 ** 9)
    logger = _logger("jax_resume")
    final = jax_train.train(cfg, args(True), logger)
    assert int(final.step) == 8
    return resumed_at(logger)


def test_resume_position_matches_jax(root, runs, tmp_path, monkeypatch):
    """Preempted after step 6 (mid-epoch 1: the first epoch's save, then
    the preemption's): the resumed run's (epoch, step, skipped batches) is
    JAX's."""
    jax_at = _jax_resumed_at(root, tmp_path / "jax", 6, monkeypatch)
    assert runs["resumed_at"] == jax_at == [(1, 6, 2)]


def test_resume_makes_the_skipped_batches_of_stateful_draws(root, tmp_path):
    """``--usetwodata`` draws each secondary frame's index from a stateful
    stream, so a resumed run makes and drops the batches its position
    skips, as JAX's resumed run does (JAX train.py:155-157): preempted after
    step 2, its first step trains the batch that a fresh loader makes
    third."""
    args = _args(root, usetwodata=True, dataroot2=root)
    run_port(_cfg(tmp_path), args, preempt_at=2)
    args.resume = True
    _, steps = run_port(_cfg(tmp_path), args, max_steps=1)
    seed = _cfg(tmp_path).TRAIN.seed
    fresh = list(PrefetchLoader(TwoDataset(args, "train", seed=seed), 2,
                                collate_two_frames, seed=seed))
    want = torch.from_numpy(fresh[2]["img"]).permute(0, 3, 1, 2)
    assert torch.equal(steps[0][2], want)
    assert not torch.equal(steps[0][2], torch.from_numpy(
        fresh[3]["img"]).permute(0, 3, 1, 2))


def test_profile_dir_writes_a_trace(runs):
    """``--profile_dir``: a Chrome trace of the first steps (to step index
    3) with the ``train_step`` ranges and the convolutions in it; the
    traced run's losses are those of the untraced preempted and resumed
    runs."""
    traces = runs["traces"]
    assert len(traces) == 1 and next(iter(traces)).endswith(".json")
    text = next(iter(traces.values()))
    assert text.count('"train_step"') == port_train.PROFILE_LAST_STEP + 1
    assert "aten::convolution" in text
    assert [s[0] for s in runs["ref_steps"]] == [
        s[0] for s in runs["killed"] + runs["resumed"]]

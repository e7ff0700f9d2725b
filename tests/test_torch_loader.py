"""The port's input pipeline against the JAX package's: ``PrefetchLoader``
batches ``np.array_equal`` to JAX ``PrefetchLoader``'s over two epochs
(``FrameDataset`` with flip and multi-scale, ``ClipDataset``,
``LongClipDataset``), a worker's exception in the consumer, the collates, the per-frame datasets' options, and on the CPU the
device prefetch giving ``to_device``'s tensors."""

import argparse
import threading

import numpy as np
import pytest
import torch

from cvpr2021_vspw_implement_tpu.data import datasets as jdata
from cvpr2021_vspw_implement_tpu.data import loader as jloader
from cvpr2021_vspw_implement_tpu_torch import data as pdata
from cvpr2021_vspw_implement_tpu_torch.parallel import (device_prefetch,
                                                        pinned_collate,
                                                        to_device)


@pytest.fixture(scope="module")
def vspw_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vspw_loader")
    pdata.make_synthetic_vspw(str(root), num_videos=5, frames_per_video=8,
                              size=(40, 56), num_class=5, seed=21)
    return str(root)


def _args(root, **kw):
    base = dict(dataroot=root, cropsize=48, clip_num=3, dilation_num=1,
                dilation2="1,2", multi_scale=True, lesslabel=False,
                trainfps=5, train_filter=False, refrng=False, use_720p=False)
    base.update(kw)
    return argparse.Namespace(**base)


CASES = {
    "FrameDataset": (pdata.collate_frames, jloader.collate_frames),
    "ClipDataset": (pdata.make_collate_target_last(1),
                    jloader.make_collate_target_last(1)),
    "LongClipDataset": (pdata.make_collate_target_last(0),
                        jloader.make_collate_target_last(0)),
}


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("cls", sorted(CASES))
def test_prefetch_loader_matches_jax(vspw_root, cls):
    """Two epochs: the order reshuffles and FrameDataset's draws are keyed
    by the epoch, so the second epoch's batches differ from the first's."""
    args = _args(vspw_root)
    collate, jcollate = CASES[cls]
    bs = 3 if cls == "FrameDataset" else 2
    mine = pdata.PrefetchLoader(getattr(pdata, cls)(args, "train", seed=7),
                                bs, collate, seed=7)
    ref = jloader.PrefetchLoader(getattr(jdata, cls)(args, "train", seed=7),
                                 bs, jcollate, seed=7)
    assert len(mine) == len(ref)
    epochs = []
    for _ in range(2):
        got, want = list(mine), list(ref)
        _assert_batches_equal(got, want)
        epochs.append(got)
    assert not np.array_equal(epochs[0][0]["img"], epochs[1][0]["img"])


def test_worker_exception_reaches_the_consumer_and_early_stop_frees_it():
    class Broken:
        def __len__(self):
            return 6

        def __getitem__(self, idx):
            if idx == 4:
                raise KeyError("item 4 is broken")
            return np.full((2, 2, 3), idx, np.float32), \
                np.zeros((2, 2), np.int32)

    order = np.arange(6)
    np.random.default_rng(3).shuffle(order)
    before_4 = order[:list(order).index(4)].tolist()
    loader = pdata.PrefetchLoader(Broken(), 1, pdata.collate_frames, seed=3,
                                  prefetch=1)
    seen = []
    with pytest.raises(KeyError, match="item 4 is broken"):
        for batch in loader:
            seen.append(int(batch["img"][0, 0, 0, 0]))
    assert seen == before_4 and len(seen) > 0
    # a consumer that stops early lets the worker go
    before = threading.active_count()
    it = iter(pdata.PrefetchLoader(Broken(), 1, pdata.collate_frames,
                                   seed=3, prefetch=1))
    next(it)
    it.close()
    for t in threading.enumerate():
        if t.name == "PrefetchLoader":
            t.join(timeout=5)
    assert threading.active_count() <= before


def test_full_batches_only():
    """7 items in batches of 3: two batches an epoch, the seventh item left
    out, every epoch a permutation of the items (JAX's ``drop_last``)."""
    class Items:
        def __len__(self):
            return 7

        def __getitem__(self, idx):
            return np.full((1, 1, 3), idx, np.float32), \
                np.zeros((1, 1), np.int32)

    loader = pdata.PrefetchLoader(Items(), 3, pdata.collate_frames, seed=5)
    ref = jloader.PrefetchLoader(Items(), 3, jloader.collate_frames, seed=5)
    assert len(loader) == len(ref) == 2
    for _ in range(2):
        got = [b["img"][:, 0, 0, 0].astype(int).tolist() for b in loader]
        want = [b["img"][:, 0, 0, 0].astype(int).tolist() for b in ref]
        assert got == want and len(got) == 2
        flat = sum(got, [])
        assert len(set(flat)) == 6 and set(flat) <= set(range(7))


def test_frame_datasets_options_match_jax(vspw_root):
    """--train_filter's 480x720 crop and the per-frame eval's --use_720p
    1080x720 resize (the clip eval dataset ignores it), against JAX."""
    args = _args(vspw_root, train_filter=True, use_720p=True)
    mine, ref = pdata.FrameDataset(args, "train", seed=4), \
        jdata.FrameDataset(args, "train", seed=4)
    for epoch in (0, 3):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        for a, b in zip(mine[1], ref[1]):
            assert a.shape[:2] == (480, 720)
            np.testing.assert_array_equal(a, b)
    mine = pdata.TestFrameDataset(vspw_root, "video_001", args)
    ref = jdata.TestFrameDataset(vspw_root, "video_001", args)
    (a, la, na), (b, lb, nb) = mine[2], ref[2]
    assert a.shape == (720, 1080, 3) and na == nb
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    clip = pdata.TestClipDataset(vspw_root, "video_001",
                                 _args(vspw_root, use_720p=True))
    assert clip[2][0].shape == (40, 56, 3)


def test_collate_clip_frames_folds_clips_into_the_batch():
    items = [([np.full((2, 2, 3), 10 * i + k, np.float32) for k in range(3)],
              [np.full((2, 2), 10 * i + k, np.int32) for k in range(3)])
             for i in range(2)]
    batch = pdata.collate_clip_frames(items)
    assert batch["img"].shape == (6, 2, 2, 3)
    assert batch["label"][:, 0, 0].tolist() == [0, 1, 2, 10, 11, 12]
    assert batch["label"].dtype == np.int32


def test_device_prefetch_on_the_cpu_is_to_device(vspw_root):
    args = _args(vspw_root)
    ds = pdata.LongClipDataset(args, "train", seed=1)
    collate = pdata.make_collate_target_last(0)
    assert pinned_collate(collate, "cpu") is collate
    host = list(pdata.PrefetchLoader(ds, 2, collate, seed=1))
    ds = pdata.LongClipDataset(args, "train", seed=1)
    loader = pdata.PrefetchLoader(ds, 2, pinned_collate(collate, "cpu"),
                                  seed=1)
    got = list(device_prefetch(loader, "cpu", 2))
    assert len(got) == len(host) == 2
    for g, h in zip(got, host):
        want = to_device(h, "cpu")
        assert g["img"].shape == (3, 2, 3, 48, 48) and g["img"].is_contiguous()
        for k in want:
            assert g[k].dtype == want[k].dtype
            assert torch.equal(g[k], want[k])
        assert not g["img"].is_pinned()

"""Batching of the train datasets (JAX counterpart: data/loader.py).

``PrefetchLoader`` walks the dataset in the JAX loader's order (the epoch's
permutation is ``default_rng(seed + epoch).shuffle``, the last short batch
dropped) on one daemon worker thread, which collates each batch and puts it
on a queue ``prefetch`` deep while the caller trains on the one before.  One
worker walking the indices in order keeps the clip datasets' stateful
draws, and so the batches, those of a serial walk.  PIL's decode and resize
run outside the GIL.  The collate functions stack numpy, channels last;
``parallel.train_state`` pins and copies them to the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


class PrefetchLoader:
    """Iterate the epoch's shuffled dataset indices, collate full batches on
    a worker thread, ``prefetch`` of them ahead.  A worker's exception is
    raised in the consumer."""

    def __init__(self, dataset, batch_size: int, collate: Callable,
                 seed: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def _index_batches(self):
        order = np.arange(len(self.dataset))
        np.random.default_rng(self.seed + self.epoch).shuffle(order)
        for s in range(0, len(self) * self.batch_size, self.batch_size):
            yield order[s:s + self.batch_size]

    def set_epoch(self, epoch: int):
        """The epoch of the next pass: its permutation and the datasets'
        per-item draws (``FrameDataset.set_epoch``)."""
        self.epoch = int(epoch)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()
        batches = list(self._index_batches())
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        self.epoch += 1

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for idxs in batches:
                    if not put(("item", self.collate(
                            [self.dataset[int(i)] for i in idxs]))):
                        return
                put(("end", None))
            except BaseException as e:   # raised in the consumer
                put(("error", e))

        thread = threading.Thread(target=worker, daemon=True,
                                  name="PrefetchLoader")
        thread.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "end":
                    return
                if kind == "error":
                    raise payload
                yield payload
        finally:
            # a consumer that stops early releases the worker
            stop.set()


def collate_frames(items):
    """[(img [H, W, 3], label [H, W])...] → {"img": [N, H, W, 3] float32,
    "label": [N, H, W] int32}."""
    imgs = np.stack([it[0] for it in items]).astype(np.float32)
    labels = np.stack([it[1] for it in items]).astype(np.int32)
    return {"img": imgs, "label": labels}


def make_collate_target_last(target_idx: int):
    """Collate clips ([imgs...], [labels...]) → [T, N, ...] stacks with the
    frame at ``target_idx`` moved to the END (the reference batch-concats
    context frames then the target frame, e.g. clip_psp.py:142-143; the
    target is clip[0] for long clips and the middle frame for contiguous
    clips, train_clip2.py:50-82)."""

    def collate(items):
        t = len(items[0][0])
        order = [k for k in range(t) if k != target_idx] + [target_idx]
        imgs = np.stack([np.stack([it[0][k] for it in items])
                         for k in order]).astype(np.float32)
        labels = np.stack([np.stack([it[1][k] for it in items])
                           for k in order]).astype(np.int32)
        return {"img": imgs, "labels": labels}

    return collate


def collate_clips_in_order(items):
    """Clips ([imgs...], [labels...]) → [T, N, ...] stacks in the sample's
    frame order (tdnet, nonlocal3d)."""
    t = len(items[0][0])
    imgs = np.stack([np.stack([it[0][k] for it in items])
                     for k in range(t)]).astype(np.float32)
    labels = np.stack([np.stack([it[1][k] for it in items])
                       for k in range(t)]).astype(np.int32)
    return {"img": imgs, "labels": labels}


def collate_clip_frames(items):
    """Long-clip samples with their frames folded into the batch (the
    per-frame trainer's ``--use_clipdataset``, reference train.py:41-50):
    {"img": [N*T, H, W, 3], "label": [N*T, H, W]}, sample by sample."""
    imgs = np.concatenate([np.stack(it[0]) for it in items])
    labels = np.concatenate([np.stack(it[1]) for it in items])
    return {"img": imgs.astype(np.float32), "label": labels.astype(np.int32)}

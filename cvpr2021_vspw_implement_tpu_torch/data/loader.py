"""Batching of the train datasets (JAX counterpart: data/loader.py).

``ClipLoader`` walks the dataset in the JAX ``PrefetchLoader``'s order (the
epoch's permutation is ``default_rng(seed + epoch).shuffle``) on the calling
thread; the collate functions stack clips [T, N, ...] as numpy, channels
last, which ``parallel.train_state.to_device`` turns into NCHW tensors.
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np


class ClipLoader:
    """Iterate shuffled dataset indices and assemble full batches (a last
    partial batch is dropped)."""

    def __init__(self, dataset, batch_size: int, collate: Callable,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def _index_batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        np.random.default_rng(self.seed + self.epoch).shuffle(order)
        for s in range(0, n - n % self.batch_size, self.batch_size):
            yield order[s:s + self.batch_size]

    def __iter__(self) -> Iterator:
        batches = list(self._index_batches())
        self.epoch += 1
        for idxs in batches:
            yield self.collate([self.dataset[int(i)] for i in idxs])


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

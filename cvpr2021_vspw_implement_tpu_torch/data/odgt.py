"""The legacy ADE20k-style odgt dataset (JAX counterpart: data/odgt.py;
reference dataset.py:70-296, dataset2.py:1352-1537, vestigial there but
part of its surface).  No entry point reads it.

Each odgt line is a JSON record {"fpath_img", "fpath_segm", "width",
"height"}.  A train item takes a random short edge from ``imgSizes`` (and
a random flip) from the dataset's ``default_rng(seed)``, caps the long edge
at ``imgMaxSize``, pads image and label to a multiple of
``padding_constant`` and takes every ``segm_downsampling_rate``-th label
pixel; a val item keeps the smallest size, padded.  Labels follow the ADE
convention (v - 1, so 0 is -1, ignored).
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

from .datasets import normalize_image


def round2multiple(x: int, p: int) -> int:
    return ((x - 1) // p + 1) * p


class OdgtDataset:
    def __init__(self, root: str, odgt, opt, split: str = "train",
                 max_sample: int = -1, seed: int | None = None):
        self.root = root
        self.split = split
        self.imgSizes = tuple(getattr(opt, "imgSizes",
                                      (300, 375, 450, 525, 600)))
        self.imgMaxSize = getattr(opt, "imgMaxSize", 1000)
        self.padding_constant = getattr(opt, "padding_constant", 8)
        self.segm_downsampling_rate = getattr(opt, "segm_downsampling_rate", 8)
        self.random_flip = getattr(opt, "random_flip", True)
        self.rng = np.random.default_rng(seed)

        if isinstance(odgt, list):
            self.list_sample = odgt
        else:
            with open(odgt) as f:
                self.list_sample = [json.loads(x) for x in f if x.strip()]
        if max_sample > 0:
            self.list_sample = self.list_sample[:max_sample]
        if not self.list_sample:
            raise ValueError(f"empty odgt list {odgt}")

    def __len__(self):
        return len(self.list_sample)

    def __getitem__(self, idx):
        rec = self.list_sample[idx]
        img = Image.open(os.path.join(self.root, rec["fpath_img"])
                         ).convert("RGB")
        segm = Image.open(os.path.join(self.root, rec["fpath_segm"]))

        if self.split == "train":
            if self.random_flip and self.rng.integers(2):
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
                segm = segm.transpose(Image.FLIP_LEFT_RIGHT)
            short = int(self.rng.choice(self.imgSizes))
        else:
            short = min(self.imgSizes)
        w, h = img.size
        scale = min(short / min(h, w), self.imgMaxSize / max(h, w))
        new_w, new_h = int(w * scale), int(h * scale)
        img = img.resize((new_w, new_h), Image.BILINEAR)
        segm = segm.resize((new_w, new_h), Image.NEAREST)

        pad_w = round2multiple(new_w, self.padding_constant)
        pad_h = round2multiple(new_h, self.padding_constant)
        arr = np.zeros((pad_h, pad_w, 3), np.float32)
        arr[:new_h, :new_w] = np.float32(np.asarray(img)) / 255.0
        lab = np.full((pad_h, pad_w), -1, np.int32)
        lab[:new_h, :new_w] = np.asarray(segm).astype(np.int32) - 1

        if self.split == "train" and self.segm_downsampling_rate > 1:
            r = self.segm_downsampling_rate
            lab = lab[r // 2::r, r // 2::r]
        return normalize_image(arr), lab

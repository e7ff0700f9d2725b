"""VSPW-480p eval data: layout, normalization, label remap (copies of the
JAX package's data/datasets.py primitives and ``TestFrameDataset``).

Layout ``<root>/data/<video>/{origin,mask}/*`` with ``<root>/<split>.txt``
video lists; ImageNet mean/std normalization; label remap 0→255 (ignore),
v→v-1, 254→255 (reference dataset2.py:531-533, 602-609).  Outputs are HWC
numpy: images float32 normalized, labels int32.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
# the JAX package normalizes uint8 frames as p * scale + shift in float32
# (native/hostops.cpp); the same two roundings give the same floats
_SCALE = np.float32(1.0 / 255.0) / STD
_SHIFT = -MEAN / STD


def normalize_image(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] → ImageNet-normalized float32."""
    if img.dtype == np.uint8:
        return img.astype(np.float32) * _SCALE + _SHIFT
    return (img - MEAN) / STD


def remap_label(segm: np.ndarray) -> np.ndarray:
    """Mask remap (reference: dataset2.py:602-609): 0→255, v→v-1, 254→255."""
    segm = segm.astype(np.int32)
    out = segm - 1
    out[segm == 0] = 255
    out[out == 254] = 255
    return out


def load_frame(dataroot: str, video: str, imgname: str,
               lesslabel: bool = False):
    """(PIL image RGB, PIL mask) of one frame."""
    img = Image.open(os.path.join(dataroot, "data", video, "origin",
                                  imgname)).convert("RGB")
    maskdir = "mask_42label" if lesslabel else "mask"
    mask = Image.open(os.path.join(dataroot, "data", video, maskdir,
                                   os.path.splitext(imgname)[0] + ".png"))
    return img, mask


def list_videos(dataroot: str, split: str) -> list[str]:
    with open(os.path.join(dataroot, split + ".txt")) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def list_frames(dataroot: str, video: str) -> list[str]:
    return sorted(os.listdir(os.path.join(dataroot, "data", video, "origin")))


class TestFrameDataset:
    """Sequential per-video eval frames (TestDataset, dataset2.py:34-141)."""

    __test__ = False  # not a pytest class

    def __init__(self, dataroot: str, video: str, args):
        self.dataroot = dataroot
        self.video = video
        self.args = args
        self.imglist = list_frames(dataroot, video)

    def __len__(self):
        return len(self.imglist)

    def __getitem__(self, idx):
        name = self.imglist[idx]
        img, mask = load_frame(self.dataroot, self.video, name,
                               getattr(self.args, "lesslabel", False))
        arr = normalize_image(np.asarray(img))
        lab = remap_label(np.asarray(mask))
        return arr, lab, os.path.splitext(name)[0] + ".png"

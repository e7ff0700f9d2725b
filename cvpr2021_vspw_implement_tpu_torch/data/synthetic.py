"""Synthetic VSPW-layout dataset generator (tests / smoke runs).

Writes ``<root>/data/<video>/{origin/*.jpg, mask/*.png}`` plus
``<root>/{train,val}.txt`` with small procedurally-generated frames whose
masks follow the raw VSPW convention (0 = unlabeled, 1..C = classes), so the
remap/metrics paths are exercised end-to-end without the real dataset.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image


def make_synthetic_vspw(root: str, num_videos: int = 2,
                        frames_per_video: int = 20, size=(64, 96),
                        num_class: int = 8, seed: int = 0,
                        splits=("train", "val")) -> None:
    rng = np.random.default_rng(seed)
    h, w = size
    videos = [f"video_{i:03d}" for i in range(num_videos)]
    for vi, video in enumerate(videos):
        odir = os.path.join(root, "data", video, "origin")
        mdir = os.path.join(root, "data", video, "mask")
        os.makedirs(odir, exist_ok=True)
        os.makedirs(mdir, exist_ok=True)
        # a moving blob per video gives temporally-correlated masks
        cx, cy = rng.integers(0, w), rng.integers(0, h)
        vx, vy = rng.integers(1, 4), rng.integers(1, 4)
        base_cls = int(rng.integers(1, num_class))
        for t in range(frames_per_video):
            yy, xx = np.mgrid[0:h, 0:w]
            blob = ((xx - cx) ** 2 + (yy - cy) ** 2) < (min(h, w) / 3) ** 2
            mask = np.full((h, w), base_cls, np.uint8)
            mask[blob] = (base_cls % num_class) + 1
            mask[0, 0] = 0  # an unlabeled pixel exercises the 0→255 remap
            img = np.stack([(mask * 29 + t) % 255,
                            (mask * 83) % 255,
                            (mask * 151) % 255], axis=-1).astype(np.uint8)
            img = img + rng.integers(0, 20, img.shape, dtype=np.uint8)
            Image.fromarray(img).save(
                os.path.join(odir, f"{t:08d}.jpg"), quality=90)
            Image.fromarray(mask).save(os.path.join(mdir, f"{t:08d}.png"))
            cx = int((cx + vx) % w)
            cy = int((cy + vy) % h)
    for split in splits:
        with open(os.path.join(root, split + ".txt"), "w") as f:
            f.write("\n".join(videos) + "\n")

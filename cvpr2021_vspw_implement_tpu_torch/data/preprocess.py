"""Offline 480p resize of a VSPW tree (JAX counterpart: data/preprocess.py;
reference change2_480p.py:11-30): every frame (bilinear) and its mask
(nearest) resized to height 480 at its aspect ratio, the split lists
copied across.  A thread pool runs the files (PIL releases the GIL while
it decodes and encodes).

    python -m cvpr2021_vspw_implement_tpu_torch.data.preprocess SRC DST \\
        [--workers N]
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

from PIL import Image


def change(src_root: str, dst_root: str, video: str, image: str) -> None:
    """Resize one frame of ``video`` and its mask, if it has one."""
    img = Image.open(os.path.join(src_root, "data", video, "origin", image))
    w, h = img.size
    size = (int(480 * w / h), 480)
    odir = os.path.join(dst_root, "data", video, "origin")
    os.makedirs(odir, exist_ok=True)
    img.resize(size, Image.BILINEAR).save(os.path.join(odir, image))

    stem = os.path.splitext(image)[0]
    mpath = os.path.join(src_root, "data", video, "mask", stem + ".png")
    if os.path.isfile(mpath):
        mdir = os.path.join(dst_root, "data", video, "mask")
        os.makedirs(mdir, exist_ok=True)
        Image.open(mpath).resize(size, Image.NEAREST).save(
            os.path.join(mdir, stem + ".png"))


def main(argv=None):
    ap = argparse.ArgumentParser(description="resize a VSPW tree to 480p")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)

    with ThreadPoolExecutor(args.workers) as pool:
        jobs = [pool.submit(change, args.src, args.dst, video, image)
                for video in sorted(os.listdir(os.path.join(args.src,
                                                            "data")))
                if not video.startswith(".")
                for image in sorted(os.listdir(os.path.join(
                    args.src, "data", video, "origin")))
                if not image.startswith(".")]
        for job in jobs:
            job.result()
    for split in ("train", "val", "test"):
        sp = os.path.join(args.src, split + ".txt")
        if os.path.isfile(sp):
            with open(sp) as f, open(os.path.join(args.dst, split + ".txt"),
                                     "w") as g:
                g.write(f.read())
    print("finish")


if __name__ == "__main__":
    main()

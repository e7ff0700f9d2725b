"""Video consistency (VC) of dumped predictions (JAX counterpart:
vc_perclip.py; reference VC_perclip.py:7-71).

Over each video of ``--split`` with more than ``--clip_num`` frames: the
sliding-window VC (``utils.metrics.video_consistency``) between the
prediction PNGs under ``--predroot/<video>/`` and the ground-truth masks,
on the raw label values (not remapped), averaged over every window of
every video.  numpy on the host; nothing runs on a card.

    python -m cvpr2021_vspw_implement_tpu_torch.vc_perclip --dataroot DATA \\
        --predroot PREDS --clip_num 8
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

from .utils import setup_logger, video_consistency


def build_parser():
    p = argparse.ArgumentParser(description="VC metric (PyTorch port)")
    p.add_argument("--dataroot", required=True)
    p.add_argument("--predroot", required=True)
    p.add_argument("--split", default="val")
    p.add_argument("--clip_num", type=int, default=16)
    return p


def compute_vc(args, logger=None) -> float:
    logger = logger or setup_logger()
    with open(os.path.join(args.dataroot, args.split + ".txt")) as f:
        videos = [line.strip() for line in f if line.strip()]

    total = []
    for video in videos:
        mdir = os.path.join(args.dataroot, "data", video, "mask")
        images = sorted(x for x in os.listdir(mdir) if not x.startswith("."))
        if len(images) <= args.clip_num:
            continue
        gts = np.stack([np.asarray(Image.open(os.path.join(mdir, n)))
                        for n in images])
        preds = np.stack([np.asarray(Image.open(
            os.path.join(args.predroot, video, n))) for n in images])
        accs = video_consistency(gts, preds, args.clip_num)
        logger.info(f"{video}: {np.nanmean(accs):.4f}")
        total.extend(accs)
    vc = float(np.nanmean(np.asarray(total)))
    logger.info(f"VC{args.clip_num} score: {vc} on {args.split} set")
    return vc


def main(argv=None) -> float:
    return compute_vc(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()

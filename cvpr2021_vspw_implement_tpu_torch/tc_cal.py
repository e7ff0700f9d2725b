"""TC (temporal consistency) metric CLI (JAX counterpart: tc_cal.py;
reference TC_cal.py:41-125).

For each adjacent frame pair of each video: RAFT flow from frame t to t+1
on the /8-padded pair, nearest warp of the t+1 prediction back onto t, and
mIoU between the t prediction and the warped one, accumulated over all pairs
of the first ``--max_videos`` videos.  By default (``--width_bucket 64``, as
the JAX CLI) each pair is padded to its width bucket and RAFT runs masked at
the reference's /8 geometry inside it; ``--width_bucket 0`` runs exact
shapes.  ``--raft_ckpt`` takes a port checkpoint (``torch.save`` of the RAFT
``state_dict``); random weights, which make the score meaningless, need
``--allow_random_raft``.

    python -m cvpr2021_vspw_implement_tpu_torch.tc_cal --dataroot DATA \\
        --predroot PREDS --allow_random_raft --device cpu
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from .models.layers import init_weights
from .models.raft import RAFT, bucketed_flow, pad_to_multiple_of_8, unpad
from .ops.masked import bucket_hw, pad_to
from .ops.warp import flowwarp
from .utils import Evaluator, resolve_device, setup_logger


def build_parser():
    p = argparse.ArgumentParser(description="TC metric (PyTorch port)")
    p.add_argument("--dataroot", required=True)
    p.add_argument("--predroot", required=True,
                   help="directory of dumped prediction PNGs per video")
    p.add_argument("--split", default="val")
    p.add_argument("--num_class", type=int, default=124)
    p.add_argument("--max_videos", type=int, default=100)
    p.add_argument("--raft_ckpt", default="",
                   help="port RAFT checkpoint: torch.save of the state_dict")
    p.add_argument("--raft_iters", type=int, default=20)
    p.add_argument("--allow_random_raft", action="store_true")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random RAFT init")
    p.add_argument("--width_bucket", type=int, default=64,
                   help="pad each frame pair to this width multiple (heights "
                        "to 32) and run the masked RAFT at the reference /8 "
                        "geometry inside the bucket; 0 = exact shapes")
    p.add_argument("--device", type=str, default="cuda")
    return p


def build_raft(args, device) -> RAFT:
    if not args.raft_ckpt and not args.allow_random_raft:
        raise SystemExit("TC needs --raft_ckpt (or --allow_random_raft for "
                         "smoke tests)")
    model = RAFT(iters=args.raft_iters)
    if args.raft_ckpt:
        model.load_state_dict(torch.load(args.raft_ckpt, map_location="cpu"))
    else:
        init_weights(model, torch.Generator().manual_seed(args.seed))
    return model.to(device).eval()


@torch.inference_mode()
def pair_flow(model, img1, img2, width_bucket: int):
    """img1/img2 [1, 3, H, W] in [0, 255] on the device → the RAFT flow
    [1, 2, H, W] from frame t to t+1 at the pair's own size.  With
    ``width_bucket`` 0 the pair runs at exact shapes, /8-padded
    (``pad_to_multiple_of_8``).  Otherwise it is zero-padded to its bucket
    and the reference's symmetric /8 pad is emulated inside it
    (``models/raft/raft.py::bucketed_flow``); the flow is cropped to
    (H, W), where it equals the exact run's up to the order of f32
    sums."""
    h, w = img1.shape[-2:]
    if not width_bucket:
        p1, pads = pad_to_multiple_of_8(img1)
        p2, _ = pad_to_multiple_of_8(img2)
        return unpad(model(p1, p2)[1], pads)
    key = bucket_hw(h, w, width_bucket)
    return bucketed_flow(model, pad_to(img1, key), pad_to(img2, key),
                         (h, w))[..., :h, :w]


def warp_pred(next_pred, flow):
    """next_pred [1, H, W] nearest-warped onto frame t by ``flow``
    [1, 2, H, W] → [1, H, W] int32."""
    warped = flowwarp(next_pred[:, None].float(), flow, mode="nearest")
    return warped[:, 0].to(torch.int32)


@torch.inference_mode()
def run_pair(model, img1, img2, next_pred, width_bucket: int):
    """img1/img2 [1, 3, H, W], next_pred [1, H, W] on the device → the next
    prediction warped onto frame t at [1, H, W], by the flow of
    :func:`pair_flow` (exact shapes when ``width_bucket`` is 0, else
    bucketed)."""
    return warp_pred(next_pred, pair_flow(model, img1, img2, width_bucket))


def compute_tc(args, model=None, logger=None) -> float:
    logger = logger or setup_logger()
    device = resolve_device(args.device)
    if model is None:
        model = build_raft(args, device)

    def load(path, dtype):
        return torch.from_numpy(np.asarray(Image.open(path), dtype))

    with open(os.path.join(args.dataroot, args.split + ".txt")) as f:
        videos = [l.strip() for l in f if l.strip()]
    if args.max_videos:
        videos = videos[:args.max_videos]

    evaluator = Evaluator(args.num_class)
    for video in videos:
        vdir = os.path.join(args.dataroot, "data", video, "origin")
        frames = sorted(x for x in os.listdir(vdir) if not x.startswith("."))
        for i, name in enumerate(frames[:-1]):
            nxt = frames[i + 1]
            img1 = load(os.path.join(vdir, name), np.float32)
            img2 = load(os.path.join(vdir, nxt), np.float32)
            stem = lambda s: os.path.splitext(s)[0] + ".png"
            pred = np.asarray(Image.open(
                os.path.join(args.predroot, video, stem(name))))[None]
            next_pred = load(os.path.join(args.predroot, video, stem(nxt)),
                             np.int32)
            warped = run_pair(
                model, img1.permute(2, 0, 1)[None].to(device),
                img2.permute(2, 0, 1)[None].to(device),
                next_pred[None].to(device), args.width_bucket)
            evaluator.add_batch(pred, warped.cpu().numpy())
        logger.info(f"TC: processed {video}")
    tc = evaluator.Mean_Intersection_over_Union()
    logger.info(f"TC score is {tc}")
    return tc


def main(argv=None):
    args = build_parser().parse_args(argv)
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return compute_tc(args)


if __name__ == "__main__":
    main()

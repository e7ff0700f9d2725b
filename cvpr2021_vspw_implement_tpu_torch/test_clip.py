"""Temporal evaluation driver, TCB-PSP streaming (JAX counterpart:
test_clip.py, ``--method clip_psp``; reference test_clip2.py).

Per video: every frame is encoded once and each window fused as its
context arrives (serving.py); global and per-video mIoU, VC, and optional
palette PNG dumps (``--is_save``).  Exact shapes only.  Flags keep the JAX
driver's names.  ``--load`` takes a port checkpoint (``torch.save`` of the
model's ``state_dict``, or the trainer's ``model_epoch_N.pth``); without it
the weights are a seeded random init.

    python -m cvpr2021_vspw_implement_tpu_torch.test_clip \\
        --cfg cvpr2021_vspw_implement_tpu_torch/config/presets/vsp-resnet18dilated-ppm_deepsup_clip.yaml \\
        --dataroot DATA --num_class 124 --device cpu
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch
from PIL import Image

from .config import cfg as default_cfg
from .data import TestFrameDataset, list_videos
from .models.clip_psp import build_clip_psp
from .models.layers import init_weights
from .serving import ClipPSPStreamer
from .utils import (Evaluator, get_common, resolve_device, setup_logger,
                    vspw_palette)


def _bool(s: str) -> bool:
    return s.lower() in ("1", "true")


def build_eval_clip_parser():
    p = argparse.ArgumentParser(description="Video segmentation eval "
                                "(PyTorch port, TCB-PSP streaming)")
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("--dataroot", type=str, default="")
    p.add_argument("--split", type=str, default="val")
    p.add_argument("--num_class", type=int, default=124)
    p.add_argument("--method", type=str, default="clip_psp",
                   choices=("clip_psp",))
    p.add_argument("--load", type=str, default="",
                   help="port checkpoint: torch.save of the state_dict, or "
                        "a checkpoint of train_clip")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random init when --load is not given")
    p.add_argument("--saveroot", type=str, default="")
    p.add_argument("--is_save", action="store_true")
    p.add_argument("--lesslabel", action="store_true")
    p.add_argument("--clip_num", type=int, default=4)
    p.add_argument("--dilation2", type=str, default="3,6,9")
    p.add_argument("--vc_clip_num", type=int, default=8)
    p.add_argument("--psp_weight", type=_bool, default=False)
    p.add_argument("--max_videos", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p


def build_model(cfg, args, device) -> torch.nn.Module:
    model = build_clip_psp(cfg, args.num_class,
                           psp_weight=args.psp_weight)
    if args.load:
        state = torch.load(args.load, map_location="cpu")
        model.load_state_dict(state.get("model", state))
    else:
        init_weights(model, torch.Generator().manual_seed(args.seed))
    return model.to(device).eval()


def evaluate_clip(cfg, args, model=None, logger=None):
    """Streaming eval over the first ``args.max_videos`` videos (0 = all);
    returns (metrics, per-video mIoU)."""
    logger = logger or setup_logger()
    device = resolve_device(args.device)
    if model is None:
        model = build_model(cfg, args, device)
    dil = args.dilation2
    dilation2 = [int(d) for d in dil.split(",")] if isinstance(dil, str) \
        else list(dil)
    if len(dilation2) + 1 != args.clip_num:
        raise ValueError("--dilation2 must hold clip_num - 1 offsets")

    evaluator = Evaluator(args.num_class)
    vmiou, vc_accs = {}, []
    palette = vspw_palette()
    videos = list_videos(args.dataroot, args.split)
    if args.max_videos:
        videos = videos[:args.max_videos]
    for video in videos:
        ds = TestFrameDataset(args.dataroot, video, args)
        eval_video = Evaluator(args.num_class)
        items = [ds[i] for i in range(len(ds))]
        h0, w0 = items[0][0].shape[:2]
        streamer = ClipPSPStreamer(model, dilation2, len(ds), (h0, w0),
                                   device=device)
        gt_list = [it[1] for it in items]
        pred_list = [None] * len(ds)
        for i, pred in streamer.run(it[0] for it in items):
            pred_list[i] = pred
            evaluator.add_batch(gt_list[i][None], pred[None])
            eval_video.add_batch(gt_list[i][None], pred[None])
            if args.is_save and args.saveroot:
                odir = os.path.join(args.saveroot, video)
                os.makedirs(odir, exist_ok=True)
                out = Image.fromarray(pred.astype(np.uint8), mode="P")
                out.putpalette(palette)
                out.save(os.path.join(odir, items[i][2]))
        h, w = gt_list[0].shape
        vc_accs.extend(get_common(gt_list, pred_list, args.vc_clip_num, h, w))
        vmiou[video] = eval_video.Mean_Intersection_over_Union()
        logger.info(f"video {video}: mIoU {vmiou[video]:.4f} (streaming)")

    metrics = {
        "Acc": evaluator.Pixel_Accuracy(),
        "Acc_class": evaluator.Pixel_Accuracy_Class(),
        "mIoU": evaluator.Mean_Intersection_over_Union(),
        "fwIoU": evaluator.Frequency_Weighted_Intersection_over_Union(),
        "video_mIoU": float(np.nanmean(list(vmiou.values()))),
        "VC": float(np.nanmean(vc_accs)) if vc_accs else float("nan"),
    }
    logger.info(
        "Acc:{Acc:.4f}, Acc_class:{Acc_class:.4f}, mIoU:{mIoU:.4f}, "
        "fwIoU:{fwIoU:.4f}, video mIoU:{video_mIoU:.4f}, "
        "VC{vc}:{VC:.4f}".format(vc=args.vc_clip_num, **metrics))
    if args.saveroot:
        os.makedirs(args.saveroot, exist_ok=True)
        with open(os.path.join(args.saveroot, "vmiou.pkl"), "wb") as f:
            pickle.dump(vmiou, f)
    return metrics, vmiou


def main(argv=None):
    args = build_eval_clip_parser().parse_args(argv)
    cfg = default_cfg.clone()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return evaluate_clip(cfg, args)


if __name__ == "__main__":
    main()

"""Per-frame evaluation CLI (JAX counterpart: test.py; reference test.py).

The per-frame model (``SegmentationModule``: ``MODEL.arch_encoder`` +
``MODEL.arch_decoder``, models/builder.py) over every frame of the split's
videos: global and per-video confusion-matrix metrics (Acc, Acc_class, mIoU,
fwIoU, video mIoU), palette PNG dumps (``--is_save``) and ``vmiou.pkl``.  By
default width-bucketed: each frame is padded to its bucket (``--width_bucket
64``; heights to the stride, 32) and the masked model takes its true size,
the band re-zeroed on the card by B6 (ops/masked.py); ``--width_bucket 0``
runs every frame at its own shape.  Weights: a seeded random init
(``--seed``), then ``--load`` (a port checkpoint: ``torch.save`` of the
state_dict, or a checkpoint of ``train``), then ``--torch_enc`` /
``--torch_dec`` (alias ``--load_en`` / ``--load_de``), reference torch
state_dicts loaded strict (pretrained.py; an HRNet checkpoint's
classification head is dropped).  ``--use_720p`` resizes frames and masks
to 1080x720, as the reference's per-frame eval does.  Encoders: every one
of ``models.builder.ModelBuilder``: the ResNets (output stride 8 or 32),
ResNeXt-101, MobileNetV2-dilated and ``hrnetv2`` (``vsp-hrnetv2.yaml``, C1
over its 720-channel map; bucketed, its fusion upsamples take the true
sizes); ``hrnetv2_clip``, which takes a (target, clips) pair, is refused:
``test_clip --method hrnetv2_clip`` evaluates it.  Decoders, each run
width-bucketed by default as in the JAX CLI's ``BUCKETED_DECODERS``:
``c1``, ``c1_deepsup``, ``ppm``, ``ppm_deepsup``, ``upernet``,
``upernet_lite``, ``deeplab``, ``nonlocal2d`` and ``ocrnet_deepsup``
(UPerNet and DeepLab derive each level's valid size from the frame's,
models/segmentation.py).

    python -m cvpr2021_vspw_implement_tpu_torch.test \\
        --cfg cvpr2021_vspw_implement_tpu_torch/config/presets/vsp-resnet18dilated-ppm_deepsup.yaml \\
        --dataroot DATA --num_class 124 --device cpu
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch
from PIL import Image

from .config import check_compute_dtype
from .config import cfg as default_cfg
from .config.args import build_eval_parser, refuse_unported
from .data import TestFrameDataset, list_videos
from .models.builder import ModelBuilder
from .models.layers import init_weights
from .models.segmentation import (SegmentationModule, inference_pred,
                                  inference_pred_rt)
from .ops.masked import bucket_hw, feature_valid, pad_to
from .pretrained import load_reference_weights
from .utils import Evaluator, resolve_device, setup_logger, vspw_palette


def build_segmentation(cfg, num_class: int) -> SegmentationModule:
    """The per-frame model of ``cfg.MODEL``, not initialised."""
    return SegmentationModule(
        ModelBuilder.build_encoder(cfg.MODEL.arch_encoder),
        ModelBuilder.build_decoder(cfg.MODEL.arch_decoder,
                                   fc_dim=cfg.MODEL.fc_dim,
                                   num_class=num_class))


def build_model(cfg, args, device, logger=None) -> SegmentationModule:
    model = build_segmentation(cfg, args.num_class)
    init_weights(model, torch.Generator().manual_seed(
        getattr(args, "seed", 0)))
    if getattr(args, "load", ""):
        state = torch.load(args.load, map_location="cpu")
        model.load_state_dict(state.get("model", state))
        if logger:
            logger.info(f"loaded checkpoint {args.load}")
    load_reference_weights(model, cfg, getattr(args, "torch_enc", ""),
                           getattr(args, "torch_dec", ""), strict=True,
                           logger=logger)
    return model.to(device).eval()


@torch.inference_mode()
def frame_pred(model, img, bucket: int = 0):
    """The prediction [B, H, W] uint8 of img [B, 3, H, W]: at its shape, or
    with ``bucket`` padded to its bucket and the masked model given its true
    size, its logits' valid region resized to (H, W) and cropped (JAX
    test.py:142-170)."""
    h, w = img.shape[-2:]
    if not bucket:
        return inference_pred(model(img), (h, w))
    pad_hw = bucket_hw(h, w, bucket)
    logits = model(pad_to(img, pad_hw), valid_hw=(h, w))[0]
    fv = feature_valid(*logits.shape[-2:], (h, w), pad_hw)
    return inference_pred_rt(logits, pad_hw, fv, (h, w))[:, :h, :w]


def evaluate(cfg, args, model=None, logger=None, max_videos: int = 0,
             is_save: bool = False):
    """Eval over the first ``max_videos`` videos of ``args.split`` (0 =
    all); returns (metrics, per-video mIoU)."""
    check_compute_dtype(cfg)
    refuse_unported(args)
    logger = logger or setup_logger()
    device = resolve_device(getattr(args, "device", "cuda"))
    if model is None:
        model = build_model(cfg, args, device, logger)
    # the trainer's validation passes its own args: exact shapes there
    bucket = getattr(args, "width_bucket", 0)

    evaluator = Evaluator(args.num_class)
    vmiou = {}
    palette = vspw_palette()
    videos = list_videos(args.dataroot, args.split)
    if max_videos:
        videos = videos[:max_videos]
    buckets, frame_s = set(), []
    for video in videos:
        ds = TestFrameDataset(args.dataroot, video, args)
        eval_video = Evaluator(args.num_class)
        for i in range(len(ds)):
            t = time.perf_counter()
            img, gt, gtname = ds[i]
            x = torch.from_numpy(np.ascontiguousarray(
                img.transpose(2, 0, 1))[None]).to(device)
            if bucket:
                buckets.add(bucket_hw(*img.shape[:2], bucket))
            pred = frame_pred(model, x, bucket)[0].cpu().numpy()
            frame_s.append(time.perf_counter() - t)
            evaluator.add_batch(gt[None], pred[None])
            eval_video.add_batch(gt[None], pred[None])
            if is_save and args.saveroot:
                odir = os.path.join(args.saveroot, video)
                os.makedirs(odir, exist_ok=True)
                out = Image.fromarray(pred.astype(np.uint8), mode="P")
                out.putpalette(palette)
                out.save(os.path.join(odir, gtname))
        vmiou[video] = eval_video.Mean_Intersection_over_Union()
        logger.info(f"video {video}: mIoU {vmiou[video]:.4f}")

    metrics = {
        "Acc": evaluator.Pixel_Accuracy(),
        "Acc_class": evaluator.Pixel_Accuracy_Class(),
        "mIoU": evaluator.Mean_Intersection_over_Union(),
        "fwIoU": evaluator.Frequency_Weighted_Intersection_over_Union(),
        "video_mIoU": float(np.nanmean(list(vmiou.values()))),
        # the (h, w) buckets touched, [] at exact shapes
        "buckets": sorted(buckets),
        # wall time of each frame: decode, forward, argmax, copy back; the
        # first carries the warm-up (cuDNN's choice of algorithms)
        "first_frame_ms": 1e3 * frame_s[0] if frame_s else float("nan"),
        "frame_ms": (1e3 * float(np.mean(frame_s[1:])) if len(frame_s) > 1
                     else float("nan")),
    }
    logger.info(
        "Acc:{Acc:.4f}, Acc_class:{Acc_class:.4f}, mIoU:{mIoU:.4f}, "
        "fwIoU:{fwIoU:.4f}, video mIoU:{video_mIoU:.4f}; {first_frame_ms:.1f} "
        "ms for the first frame, then {frame_ms:.1f} ms/frame".format(
            **metrics))
    if args.saveroot:
        os.makedirs(args.saveroot, exist_ok=True)
        with open(os.path.join(args.saveroot, "vmiou.pkl"), "wb") as f:
            pickle.dump(vmiou, f)
    return metrics, vmiou


def main(argv=None):
    args = build_eval_parser().parse_args(argv)
    refuse_unported(args)
    cfg = default_cfg.clone()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return evaluate(cfg, args, max_videos=args.max_videos,
                    is_save=args.is_save)


if __name__ == "__main__":
    main()

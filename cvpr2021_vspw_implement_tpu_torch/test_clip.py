"""Temporal evaluation CLI (JAX counterpart: test_clip.py; reference
test_clip2.py).

``--method clip_psp`` and ``clip_ocr`` stream (serving.py: every frame is
encoded once and each window fused as its context arrives), by default
width-bucketed: each frame is padded to its bucket (``--width_bucket 64``;
heights to the stride 32) and the masked model takes its true size
(ops/masked.py).  ``--eval_policy exact`` runs every frame at its own shape,
and ``auto`` runs a shape exactly where the val list holds at least
``--exact_min_frames`` of its frames (the JAX CLI's policy and defaults).
``clip_ocr`` with ``--use_memory`` (a ring of the last ``--memory_num`` + 1
region contexts, carried from window to window and emptied at each video's
start) or ``--clipocr_all`` takes the window path over its long clips
(``TestLongClipDataset``), which the streamer cannot serve.
``--method netwarp`` and ``netwarp_ocr`` stream pairs (each frame's
features computed once), width-bucketed unless ``--width_bucket 0``; with
``--dilation_num`` > 0 they take the window path at exact shapes, as the
JAX CLI does.  ``--method our_warp``, ``ETC``, ``etc_ocr``, ``propnet``,
``our_warp_merge`` and ``hrnetv2_clip`` take the window path: per eval
frame, its centred
``clip_num`` neighbourhood (``TestClipDataset``) and the frame itself,
target last, go through the model at once, padded to the frame's bucket
with its true size beside it unless ``--width_bucket 0`` (``--eval_policy``
governs the TCB streaming engines only, as in the JAX CLI).
``hrnetv2_clip``'s model gives its encoder the target and the context
frames apart (``SegmentationModuleClip``) and always blends them
(TimeAtten): the JAX CLI has no ``--clip_middle``.
``--method tdnet`` streams frame by frame, path ``i % 4`` with the video's
K/V/Q carry (serving.py ``TDNetStreamer``), bucketed by default and under
``--eval_policy`` as the TCB streamers.  ``--method nonlocal3d`` takes
``test_all``: each window of ``clip_num`` frames (the eval frame in it)
through the model, each frame's probabilities averaged on the card over
the windows that hold it and argmaxed once it has been seen ``clip_num``
times (the rest at the video's end), bucketed unless ``--width_bucket 0``.
Global and per-video mIoU, VC, and optional
palette PNG dumps (``--is_save``).  Flags keep the JAX CLI's names.
``--load`` takes a port checkpoint (``torch.save`` of the model's
``state_dict``, or the trainer's ``model_epoch_N.pth``); without it the
weights are a seeded random init.  ``--torch_load`` loads a reference
fused clip-model ``.pth`` (the reference's run scripts pass it) over them,
for the clip trainer's methods, which the JAX CLI imports; any other
method is refused by name.

    python -m cvpr2021_vspw_implement_tpu_torch.test_clip \\
        --cfg cvpr2021_vspw_implement_tpu_torch/config/presets/vsp-resnet18dilated-ppm_deepsup_clip.yaml \\
        --dataroot DATA --num_class 124 --method our_warp --device cpu
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch
from PIL import Image

from .config import check_compute_dtype
from .config import cfg as default_cfg
from .config.args import TEMPORAL_METHODS, postprocess_args
from .data import (TestClipDataset, TestFrameDataset, TestLongClipDataset,
                   list_videos)
from .methods import build_method
from .models.clip_ocr import init_memory
from .models.layers import init_weights
from .models.segmentation import (inference_pred, inference_pred_rt,
                                  inference_probs, inference_probs_rt)
from .ops.masked import bucket_hw, feature_valid, pad_to
from .pretrained import reference_renamed
from .serving import (ClipOCRBucketEngine, ClipOCRStreamer,
                      ClipPSPBucketEngine, ClipPSPStreamer, ExactShapeEngine,
                      NetWarpBucketEngine, NetWarpStreamer, TDNetStreamer,
                      video_shape_census)
from .utils import (Evaluator, get_common, resolve_device, setup_logger,
                    vspw_palette)

#: methods whose eval is ported: the TCB methods stream windows, netwarp
#: and netwarp_ocr stream pairs, tdnet frames, nonlocal3d averages windows,
#: the others take windows
EVAL_METHODS = ("clip_psp", "clip_ocr", "netwarp", "netwarp_ocr", "our_warp",
                "ETC", "etc_ocr", "propnet", "our_warp_merge", "tdnet",
                "nonlocal3d", "hrnetv2_clip")
#: the TCB streamers and bucket engines by method
TCB_STREAMERS = {"clip_psp": (ClipPSPStreamer, ClipPSPBucketEngine),
                 "clip_ocr": (ClipOCRStreamer, ClipOCRBucketEngine)}


def _bool(s: str) -> bool:
    return s.lower() in ("1", "true")


def build_eval_clip_parser():
    p = argparse.ArgumentParser(description="Video segmentation eval "
                                "(PyTorch port)")
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("--dataroot", type=str, default="")
    p.add_argument("--split", type=str, default="val")
    p.add_argument("--num_class", type=int, default=124)
    p.add_argument("--method", type=str, default="clip_psp",
                   choices=EVAL_METHODS)
    p.add_argument("--load", type=str, default="",
                   help="port checkpoint: torch.save of the state_dict, or "
                        "a checkpoint of train_clip")
    p.add_argument("--torch_load", type=str, default="",
                   help="reference fused clip-model .pth of a clip "
                        "trainer's method, loaded over the seeded init")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random init when --load is not given")
    p.add_argument("--saveroot", type=str, default="")
    p.add_argument("--is_save", action="store_true")
    p.add_argument("--lesslabel", action="store_true")
    p.add_argument("--clip_num", type=int, default=4)
    p.add_argument("--dilation_num", type=int, default=0)
    p.add_argument("--dilation2", type=str, default="3,6,9")
    p.add_argument("--vc_clip_num", type=int, default=8)
    p.add_argument("--use_memory", type=_bool, default=False,
                   help="clip_ocr: blend over a ring of the last "
                        "--memory_num + 1 region contexts (window path)")
    p.add_argument("--memory_num", type=int, default=8)
    p.add_argument("--clipocr_all", type=_bool, default=False,
                   help="clip_ocr: OCR attention on every clip frame "
                        "(window path)")
    p.add_argument("--psp_weight", type=_bool, default=False)
    p.add_argument("--linear_combine", type=_bool, default=False)
    p.add_argument("--distsoftmax", type=_bool, default=False)
    p.add_argument("--distnearest", type=_bool, default=False)
    p.add_argument("--temp", type=float, default=3)
    p.add_argument("--max_distances", type=str, default="10")
    p.add_argument("--max_videos", type=int, default=0)
    p.add_argument("--width_bucket", type=int, default=64,
                   help="pad eval frame widths to multiples of this "
                        "(heights to the stride, 32) and run the masked "
                        "model at the true size (ops/masked.py); 0 = exact "
                        "shapes")
    p.add_argument("--eval_policy", choices=("bucketed", "exact", "auto"),
                   default="bucketed",
                   help="clip_psp streaming: 'bucketed' pads to the width "
                        "bucket, 'exact' runs each frame at its shape, "
                        "'auto' runs a shape exactly where the val list "
                        "holds at least --exact_min_frames of its frames")
    p.add_argument("--exact_min_frames", type=int, default=15000,
                   help="auto policy: frames a shape needs across the val "
                        "list to run exactly (the JAX CLI's default, set "
                        "for its compile cost on a TPU)")
    p.add_argument("--cropsize", type=int, default=479,
                   help="tdnet: the train crop its LayerNorm maps were made "
                        "for, int(cropsize / 8) + 1 a side (the JAX CLI's "
                        "fixed 479)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p


def build_model(cfg, args, device, logger=None) -> torch.nn.Module:
    """The method's model on ``device`` in eval mode: ``--load`` (a port
    checkpoint), else the seeded init, with ``--torch_load`` over it."""
    method = getattr(args, "method", "clip_psp")
    torch_load = getattr(args, "torch_load", "")
    # the clip trainer's methods, whose fused checkpoints JAX imports
    # (models/import_torch.py ``FUSED_IMPORTERS``)
    if torch_load and method not in TEMPORAL_METHODS:
        raise ValueError(f"--torch_load supports {sorted(TEMPORAL_METHODS)} "
                         f"fused checkpoints, not --method {method}")
    model, _ = build_method(method, cfg, args)
    if args.load:
        state = torch.load(args.load, map_location="cpu")
        model.load_state_dict(state.get("model", state))
    else:
        init_weights(model, torch.Generator().manual_seed(args.seed))
    if torch_load:
        load_fused(model, torch_load, logger)
    return model.to(device).eval()


def load_fused(model, path: str, logger=None) -> None:
    """A reference fused clip-model checkpoint (train_clip2.py:179-189)
    over ``model`` in place, as JAX's ``merge_variables`` overlays its
    import: the ``module.`` prefix and ``num_batches_tracked`` go
    (``pretrained.reference_renamed``); an entry the model has no place for
    raises, and a parameter the checkpoint lacks keeps its init."""
    missing, unexpected = model.load_state_dict(
        reference_renamed(torch.load(path, map_location="cpu")),
        strict=False)
    if unexpected:
        raise KeyError(f"{path}: entries the model lacks: {unexpected}")
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if logger:
        logger.info(f"imported fused torch checkpoint {path}"
                    + (f"; kept the init of {missing}" if missing else ""))


def _stream(model, ds, dilation2, device, engine=None,
            streamer_cls=ClipPSPStreamer):
    """(index, prediction, label, PNG name) of every frame of ``ds``,
    streaming windows through ``engine`` (exact shapes when None)."""
    items = [ds[i] for i in range(len(ds))]
    streamer = streamer_cls(model, dilation2, len(ds), items[0][0].shape[:2],
                            device=device, engine=engine)
    for i, pred in streamer.run(it[0] for it in items):
        yield i, pred, items[i][1], items[i][2]


def _stream_pairs(model, ds, device, engine=None):
    """(index, prediction, label, PNG name) of every frame of ``ds``,
    NetWarp pairs streamed through ``engine`` (exact shapes when None)."""
    items = [ds[i] for i in range(len(ds))]
    streamer = NetWarpStreamer(model, len(ds), items[0][0].shape[:2],
                               device=device, engine=engine)
    for i, pred in streamer.run([it[0] for it in items]):
        yield i, pred, items[i][1], items[i][2]


@torch.inference_mode()
def window_pred(model, imgs, bucket: int = 0, memory=None):
    """The prediction [B, H, W] of a window imgs [T, B, 3, H, W], target
    last: at its shape, or with ``bucket`` padded to its bucket and the
    masked model given its true size, its logits' valid region resized to
    (H, W) and cropped (JAX test_clip.py:266-357).  With ``memory``
    (clip_ocr's ring) the model blends over it: → (prediction, new
    memory)."""
    h, w = imgs.shape[-2:]
    kw = {} if memory is None else {"memory": memory}
    if bucket:
        pad_hw = bucket_hw(h, w, bucket)
        out = model(pad_to(imgs, pad_hw), valid_hw=(h, w), **kw)
    else:
        out = model(imgs, **kw)
    if memory is not None:
        out, memory = out
    if not bucket:
        pred = inference_pred(out, (h, w))
    else:
        fv = feature_valid(*out[0].shape[-2:], (h, w), pad_hw)
        pred = inference_pred_rt(out[0], pad_hw, fv, (h, w))[:, :h, :w]
    return pred if memory is None else (pred, memory)


@torch.inference_mode()
def window_probs(model, imgs, bucket: int = 0) -> list:
    """nonlocal3d: the probabilities [B, K, H, W] of each frame of a window
    imgs [T, B, 3, H, W], at its shape or, with ``bucket``, padded to its
    bucket with the masked model given its true size (JAX
    test_clip.py:247-253, :305-323)."""
    h, w = imgs.shape[-2:]
    if not bucket:
        logits = model(imgs)
        return [inference_probs(lg, (h, w)) for lg in logits]
    pad_hw = bucket_hw(h, w, bucket)
    logits = model(pad_to(imgs, pad_hw), valid_hw=(h, w))
    fv = feature_valid(*logits.shape[-2:], (h, w), pad_hw)
    return [inference_probs_rt(lg, pad_hw, fv, (h, w))[..., :h, :w]
            for lg in logits]


def frame_pred(acc: torch.Tensor, n: int) -> torch.Tensor:
    """The prediction [B, H, W] uint8 of a frame whose probabilities summed
    over ``n`` windows are ``acc``: the argmax of their mean."""
    return torch.argmax(acc / n, dim=1).to(torch.uint8)


@torch.inference_mode()
def _test_all(model, ds, device, clip_num: int, bucket: int = 0):
    """nonlocal3d's ``test_all`` (JAX test_clip.py:113-160; reference
    test_clip2.py:90-195): (index, prediction, label, PNG name) of each
    frame as it is flushed.  Its probabilities are summed on the card, in
    window order, over the windows that hold it; once it has been seen
    more than ``clip_num - 1`` times, or at the video's end, the mean is
    argmaxed and only the prediction leaves the card."""
    sums, seen, labels, done = {}, {}, {}, set()

    def flush(name):
        pred = frame_pred(sums.pop(name), seen.pop(name))
        done.add(name)
        return (ds.imglist.index(name), pred[0].cpu().numpy(), labels[name],
                os.path.splitext(name)[0] + ".png")

    for i in range(len(ds)):
        _, _, clips, cliplabs, _, names = ds[i]
        imgs = torch.from_numpy(np.ascontiguousarray(
            np.stack(clips)[:, None].transpose(0, 1, 4, 2, 3))).to(device)
        probs = window_probs(model, imgs, bucket)
        for t, name in enumerate(names):
            if name in done:
                continue
            labels.setdefault(name, cliplabs[t])
            if name in sums:
                sums[name] += probs[t]
                seen[name] += 1
            else:
                sums[name], seen[name] = probs[t], 1
            if seen[name] > clip_num - 1:
                yield flush(name)
    for name in list(sums):
        yield flush(name)


def _windows(model, ds, device, bucket: int = 0, memory=None):
    """(index, prediction, label, PNG name) of every frame of ``ds``: its
    context window and itself, target last, through the model at once (JAX
    test_clip.py:566-602); ``memory`` is carried from window to window."""
    for i in range(len(ds)):
        img, gt, clips, _, name = ds[i]
        imgs = np.stack(clips + [img])[:, None]           # [T, 1, H, W, 3]
        imgs = torch.from_numpy(np.ascontiguousarray(
            imgs.transpose(0, 1, 4, 2, 3))).to(device)   # [T, 1, 3, H, W]
        if memory is None:
            pred = window_pred(model, imgs, bucket)
        else:
            pred, memory = window_pred(model, imgs, bucket, memory)
        yield i, pred[0].cpu().numpy(), gt, name


def evaluate_clip(cfg, args, model=None, logger=None):
    """Eval over the first ``args.max_videos`` videos (0 = all); returns
    (metrics, per-video mIoU)."""
    check_compute_dtype(cfg)
    logger = logger or setup_logger()
    device = resolve_device(args.device)
    use_memory = getattr(args, "use_memory", False)
    # the streamers serve clip_ocr neither with a memory nor with
    # clipocr_all, and NetWarp's only with contiguous pairs (JAX
    # test_clip.py:374-412)
    streaming = args.method == "clip_psp" or (
        args.method == "clip_ocr" and not use_memory
        and not getattr(args, "clipocr_all", False))
    pairs = (args.method in ("netwarp", "netwarp_ocr")
             and args.dilation_num == 0)
    tdnet = args.method == "tdnet"
    # the trainer's validation passes its own args: exact shapes there
    bucket = getattr(args, "width_bucket", 0)
    policy = getattr(args, "eval_policy", "bucketed")
    if model is None:
        model = build_model(cfg, args, device, logger)
    if streaming:
        streamer_cls, bucket_engine = TCB_STREAMERS[args.method]
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
    # the eval-shape policy (JAX test_clip.py:416-467): one bucketed engine
    # shared by all videos; 'exact' and 'auto' run shapes exactly, 'auto'
    # where the val list holds enough frames of the shape
    engine = exact_engine = census = None
    if pairs and bucket:
        engine = NetWarpBucketEngine(model, bucket=bucket)
    if streaming:
        if policy != "exact" and bucket:
            engine = bucket_engine(model, bucket=bucket)
        if policy in ("exact", "auto"):
            exact_engine = ExactShapeEngine(model, device)
    if (streaming or tdnet) and policy == "auto":
        census, vshapes = video_shape_census(args.dataroot, videos)
    td_buckets = set()
    frame_s = []      # wall time of each prediction: decode, forward, argmax
    for video in videos:
        exact = policy == "exact" or (
            census is not None and census.get(vshapes.get(video), 0)
            >= getattr(args, "exact_min_frames", 15000))
        if streaming:
            ds = TestFrameDataset(args.dataroot, video, args)
            preds = _stream(model, ds, dilation2, device,
                            exact_engine if exact else engine, streamer_cls)
        elif tdnet:
            # the eval-shape policy as the TCB streamers' (JAX
            # test_clip.py:500-531): exact shapes drop the bucket
            ds = TestFrameDataset(args.dataroot, video, args)
            items = [ds[i] for i in range(len(ds))]
            td_bucket = 0 if exact else bucket
            streamer = TDNetStreamer(model, items[0][0].shape[:2], device,
                                     td_bucket,
                                     td_buckets if td_bucket else set())
            preds = ((i, pred, items[i][1], items[i][2])
                     for i, pred in streamer.run(it[0] for it in items))
        elif args.method == "nonlocal3d":
            ds = TestClipDataset(args.dataroot, video, args)
            preds = _test_all(model, ds, device, args.clip_num, bucket)
        elif pairs:
            ds = TestFrameDataset(args.dataroot, video, args)
            preds = _stream_pairs(model, ds, device, engine)
        elif args.method == "clip_ocr":
            # the window path over long clips; the memory starts empty at
            # each video (reference is_clean_memory, test_clip2.py:44-48)
            ds = TestLongClipDataset(args.dataroot, video, args)
            memory = (init_memory(args.memory_num, 1, args.num_class,
                                  device=device) if use_memory else None)
            preds = _windows(model, ds, device, bucket, memory)
        else:
            ds = TestClipDataset(args.dataroot, video, args)
            # NetWarp's window forward has no masked path (JAX
            # BUCKETED_WINDOW_METHODS)
            preds = _windows(model, ds, device,
                             0 if args.method.startswith("netwarp")
                             else bucket)
        eval_video = Evaluator(args.num_class)
        gt_list, pred_list = [None] * len(ds), [None] * len(ds)
        t = time.perf_counter()
        for i, pred, gt, name in preds:
            frame_s.append(time.perf_counter() - t)
            gt_list[i], pred_list[i] = gt, pred
            evaluator.add_batch(gt[None], pred[None])
            eval_video.add_batch(gt[None], pred[None])
            if args.is_save and args.saveroot:
                odir = os.path.join(args.saveroot, video)
                os.makedirs(odir, exist_ok=True)
                out = Image.fromarray(pred.astype(np.uint8), mode="P")
                out.putpalette(palette)
                out.save(os.path.join(odir, name))
            t = time.perf_counter()
        h, w = gt_list[0].shape
        vc_accs.extend(get_common(gt_list, pred_list, args.vc_clip_num, h, w))
        vmiou[video] = eval_video.Mean_Intersection_over_Union()
        logger.info(f"video {video}: mIoU {vmiou[video]:.4f}"
                    + (" (streaming)" if streaming or pairs or tdnet else "")
                    + (" (test_all)" if args.method == "nonlocal3d" else ""))

    metrics = {
        # the bucketed engine's (h, w) buckets touched, else []
        "buckets": (engine.encode_shapes if engine is not None
                    else sorted(td_buckets)),
        "Acc": evaluator.Pixel_Accuracy(),
        "Acc_class": evaluator.Pixel_Accuracy_Class(),
        "mIoU": evaluator.Mean_Intersection_over_Union(),
        "fwIoU": evaluator.Frequency_Weighted_Intersection_over_Union(),
        "video_mIoU": float(np.nanmean(list(vmiou.values()))),
        "VC": float(np.nanmean(vc_accs)) if vc_accs else float("nan"),
        # the first frame carries the warm-up (cuDNN's choice of algorithms);
        # when streaming, it also waits for the context frames after it
        "first_frame_ms": 1e3 * frame_s[0] if frame_s else float("nan"),
        "frame_ms": (1e3 * float(np.mean(frame_s[1:])) if len(frame_s) > 1
                     else float("nan")),
    }
    logger.info(
        "Acc:{Acc:.4f}, Acc_class:{Acc_class:.4f}, mIoU:{mIoU:.4f}, "
        "fwIoU:{fwIoU:.4f}, video mIoU:{video_mIoU:.4f}, "
        "VC{vc}:{VC:.4f}; {first_frame_ms:.1f} ms for the first frame, then "
        "{frame_ms:.1f} ms/frame".format(vc=args.vc_clip_num, **metrics))
    if args.saveroot:
        os.makedirs(args.saveroot, exist_ok=True)
        with open(os.path.join(args.saveroot, "vmiou.pkl"), "wb") as f:
            pickle.dump(vmiou, f)
    return metrics, vmiou


def main(argv=None):
    args = build_eval_clip_parser().parse_args(argv)
    postprocess_args(args)
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

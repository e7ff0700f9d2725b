"""Where the bucket tax of the PyTorch port's eval goes on the GPU.

    python3 tools/torch_bucket_profile.py [--out DIR]
    python3 tools/torch_bucket_profile.py --method clip_ocr [--out DIR]
    python3 tools/torch_bucket_profile.py --method netwarp [--out DIR]
    python3 tools/torch_bucket_profile.py --method hrnet [--out DIR]

Builds the R101 ClipPSP of ``test_clip`` and the RAFT of ``tc_cal`` (seeded
random weights, 124 classes, RAFT at 20 refinements, f32 without TF32) and
one 480x853 frame pair, then compares exact shapes with width-bucketed eval
in the 480x896 bucket:

* ``ClipPSP.encode_frame`` on one frame: exact as the exact engine gives it
  (a permuted HWC view, which cuDNN runs channels-last), exact as contiguous
  NCHW, and bucketed (contiguous NCHW, padded, masked);
* the rest of a streamed frame, ``fuse_target`` then upsample and argmax as
  the engines run them, on each of those three C5s;
* one TC pair: ``tc_cal.run_pair`` with ``width_bucket`` 0 and 64.

``--method clip_ocr`` times the R101 ClipOCRNet of ``test_clip`` (the OCR
preset) instead: ``encode_frame`` and ``fuse_target`` (then upsample and
argmax), exact (contiguous NCHW) and bucketed.  ``--method netwarp`` (or
``netwarp_ocr``) its streamed frame: ``encode_frame`` and the pair's
``fuse_pair`` (RAFT at 20 refinements, FlowCNN, warps, the target's decode,
the classifier, then upsample and argmax), exact and bucketed, and the
RAFT pair alone (``bucketed_flow`` or the /8-padded exact call).
``--method hrnet`` the per-frame HRNetV2-W48 + C1 (``vsp-hrnetv2.yaml``,
a frame as ``test.frame_pred`` runs it, contiguous NCHW) and an
``hrnetv2_clip`` window of 4 frames (``test_clip.window_pred``), each
exact and bucketed.

Each form is timed on CUDA events (10 calls after 2, in the order of the
list and then in reverse), then run 3 times under ``torch.profiler``: prints
the device busy time per call (the sum of its kernels' device times), the
kernels that take most of it, and the band re-zero kernel's device time per
launch; writes the profiler's tables to ``DIR``.

Needs a CUDA device.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cvpr2021_vspw_implement_tpu_torch import tc_cal, test_clip  # noqa: E402
from cvpr2021_vspw_implement_tpu_torch.config import cfg as default_cfg  # noqa: E402
from cvpr2021_vspw_implement_tpu_torch.models.segmentation import (  # noqa: E402
    inference_pred, inference_pred_rt)
from cvpr2021_vspw_implement_tpu_torch.ops.masked import (  # noqa: E402
    feature_valid, pad_to)

PRESETS = os.path.join(REPO, "cvpr2021_vspw_implement_tpu_torch", "config",
                       "presets")
PRESET = os.path.join(PRESETS, "vsp-resnet101dilated-ppm_deepsup_clip.yaml")
OCR_PRESET = os.path.join(PRESETS, "vsp-resnet101dilated-ocr_deepsup.yaml")
H, W, PAD = 480, 853, (480, 896)


def event_ms(fn, n=10, warm=2):
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def clip_ocr_forms(img):
    """The forms of a streamed TCB-OCR frame: encode and fuse, exact and
    bucketed."""
    cfg = default_cfg.clone()
    cfg.merge_from_file(OCR_PRESET)
    model = test_clip.build_model(cfg, test_clip.build_eval_clip_parser()
                                  .parse_args(["--cfg", OCR_PRESET,
                                               "--method", "clip_ocr"]),
                                  "cuda")
    img = img.contiguous()
    with torch.inference_mode():
        feat, ctx = model.encode_frame(img)
        feat_b, ctx_b = model.encode_frame(pad_to(img, PAD), valid_hw=(H, W))
    fv = feature_valid(*feat_b.shape[-2:], (H, W), PAD)
    return {
        "encode, exact (NCHW)": lambda: model.encode_frame(img),
        "encode, bucketed": lambda: model.encode_frame(
            pad_to(img, PAD), valid_hw=(H, W)),
        "fuse, exact": lambda: inference_pred(
            model.fuse_target(feat, ctx), (H, W)),
        "fuse, bucketed": lambda: inference_pred_rt(
            model.fuse_target(feat_b, ctx_b), PAD, fv, (H, W)),
    }


def netwarp_forms(img, method):
    """The forms of a streamed NetWarp frame: its encode and its pair's
    fuse, exact and bucketed, and the RAFT pair alone."""
    from cvpr2021_vspw_implement_tpu_torch.models.etc import denormalize_255
    from cvpr2021_vspw_implement_tpu_torch.models.raft import (
        bucketed_flow, pad_to_multiple_of_8)

    preset = OCR_PRESET if method == "netwarp_ocr" else PRESET
    cfg = default_cfg.clone()
    cfg.merge_from_file(preset)
    model = test_clip.build_model(cfg, test_clip.build_eval_clip_parser()
                                  .parse_args(["--cfg", preset, "--method",
                                               method, "--clip_num", "2"]),
                                  "cuda")
    prev = img.contiguous()
    target = torch.roll(prev, (2, 3), (2, 3))
    padded = [pad_to(x, PAD) for x in (prev, target)]
    with torch.inference_mode():
        cache = [model.encode_frame(x) for x in (prev, target)]
        cache_b = [model.encode_frame(x, valid_hw=(H, W)) for x in padded]
    c4 = (lambda c: c[2] if model.ocr else None)

    def pair(bucketed):
        (p, t), (cp, ct) = ((padded, cache_b) if bucketed
                            else ((prev, target), cache))
        kw = {"valid_hw": (H, W)} if bucketed else {}
        logits, _ = model.fuse_pair(t, p, ct[0], cp[0], cp[1], c4(ct), **kw)
        if not bucketed:
            return inference_pred(logits, (H, W))
        fv = feature_valid(*logits.shape[-2:], (H, W), PAD)
        return inference_pred_rt(logits, PAD, fv, (H, W))

    images = [denormalize_255(x) for x in (target, prev)]
    images_b = [denormalize_255(x) for x in padded[::-1]]
    for x in images_b:
        x[..., W:] = 0
    return {
        "encode, exact (NCHW)": lambda: model.encode_frame(target),
        "encode, bucketed": lambda: model.encode_frame(padded[1],
                                                       valid_hw=(H, W)),
        "pair, exact": lambda: pair(False),
        "pair, bucketed": lambda: pair(True),
        "RAFT pair, exact": lambda: model.raft(*(
            pad_to_multiple_of_8(x)[0] for x in images)),
        "RAFT pair, bucketed": lambda: bucketed_flow(model.raft, *images_b,
                                                     (H, W)),
    }


def hrnet_forms(img):
    """Per-frame HRNetV2 + C1 and an hrnetv2_clip window, exact and
    bucketed (seeded weights)."""
    from cvpr2021_vspw_implement_tpu_torch import test as frame_test

    forms = {}
    for name in ("hrnetv2", "hrnetv2_clip"):
        preset = os.path.join(PRESETS, f"vsp-{name}.yaml")
        cfg = default_cfg.clone()
        cfg.merge_from_file(preset)
        if name == "hrnetv2":
            model = frame_test.build_model(
                cfg, frame_test.build_eval_parser().parse_args(
                    ["--cfg", preset]), "cuda")
            x = img.contiguous()
            forms.update({
                "frame, exact (NCHW)":
                    lambda m=model: frame_test.frame_pred(m, x),
                "frame, bucketed":
                    lambda m=model: frame_test.frame_pred(m, x, 64)})
        else:
            model = test_clip.build_model(
                cfg, test_clip.build_eval_clip_parser().parse_args(
                    ["--cfg", preset, "--method", name]), "cuda")
            window = torch.roll(img, (2, 3), (2, 3)).contiguous()
            window = torch.stack([torch.roll(window, (i, i), (2, 3))
                                  for i in range(4)])
            forms.update({
                "hrnetv2_clip window, exact":
                    lambda m=model: test_clip.window_pred(m, window),
                "hrnetv2_clip window, bucketed":
                    lambda m=model: test_clip.window_pred(m, window, 64)})
    return forms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    ap.add_argument("--method", default="clip_psp",
                    choices=("clip_psp", "clip_ocr", "netwarp",
                             "netwarp_ocr", "hrnet"))
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bucket_profile: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    rng = np.random.default_rng(0)
    frame = torch.from_numpy(rng.standard_normal((H, W, 3), np.float32))
    img = frame.cuda().permute(2, 0, 1)[None]
    if opts.method == "clip_ocr":
        return profile_forms(clip_ocr_forms(img), opts)
    if opts.method.startswith("netwarp"):
        return profile_forms(netwarp_forms(img, opts.method), opts)
    if opts.method == "hrnet":
        return profile_forms(hrnet_forms(img), opts)
    cfg = default_cfg.clone()
    cfg.merge_from_file(PRESET)
    model = test_clip.build_model(cfg, test_clip.build_eval_clip_parser()
                                  .parse_args(["--cfg", PRESET]), "cuda")
    raft = tc_cal.build_raft(tc_cal.build_parser().parse_args(
        ["--dataroot", "", "--predroot", "", "--allow_random_raft",
         "--raft_iters", "20"]), "cuda")
    pair = [torch.from_numpy(rng.uniform(0, 255, (H, W, 3)).astype(
        np.float32)).cuda().permute(2, 0, 1)[None] for _ in range(2)]
    next_pred = torch.from_numpy(rng.integers(0, 124, (1, H, W),
                                              dtype=np.int32)).cuda()
    with torch.inference_mode():
        c5s = {"exact (permuted view)": model.encode_frame(img),
               "exact (NCHW)": model.encode_frame(img.contiguous()),
               "bucketed": model.encode_frame(pad_to(img, PAD),
                                              valid_hw=(H, W))}
    fv = feature_valid(*c5s["bucketed"][0].shape[-2:], (H, W), PAD)

    def fuse(form):
        c5, pooled = c5s[form]
        if form != "bucketed":
            return inference_pred(model.fuse_target(c5, pooled), (H, W))
        return inference_pred_rt(model.fuse_target(c5, pooled, feat_valid=fv),
                                 PAD, fv, (H, W))

    forms = {
        "encode, exact (permuted view)": lambda: model.encode_frame(img),
        "encode, exact (NCHW)": lambda: model.encode_frame(img.contiguous()),
        "encode, bucketed": lambda: model.encode_frame(
            pad_to(img, PAD), valid_hw=(H, W)),
        **{f"fuse, {form}": lambda form=form: fuse(form) for form in c5s},
        "TC pair, exact": lambda: tc_cal.run_pair(raft, *pair, next_pred, 0),
        "TC pair, bucketed": lambda: tc_cal.run_pair(raft, *pair, next_pred,
                                                     64),
    }
    return profile_forms(forms, opts)


def profile_forms(forms, opts) -> int:
    """Time each form on CUDA events, in order and reversed, then profile
    it; prints and writes the tables to ``opts.out``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(opts.out, exist_ok=True)
    with torch.inference_mode():
        times = {name: [] for name in forms}
        for name in [*forms, *reversed(forms)]:
            times[name].append(event_ms(forms[name]))
        for name, fn in forms.items():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0]
            t = times[name]
            print(f"{name}: {t[0]:.2f} and {t[1]:.2f} ms a call (CUDA "
                  "events, in order and reversed)")
            if not events:
                print("  the profiler reported no device time")
                continue
            busy = sum(e.self_device_time_total for e in events) / 3e3
            print(f"  device busy {busy:.2f} ms a call; kernels by device "
                  "time (ms a call, launches a call):")
            events.sort(key=lambda e: -e.self_device_time_total)
            for e in events[:8]:
                print(f"  {e.self_device_time_total / 3e3:8.3f}  "
                      f"{e.count // 3:5d}  {e.key[:90]}")
            for e in events:
                if "band_zero" in e.key:
                    print(f"  band_zero kernel: {e.count // 3} launches a "
                          f"call, {e.self_device_time_total / e.count:.2f} "
                          "us of device time a launch")
            slug = re.sub(r"\W+", "_", f"{opts.method} {name}").strip("_")
            with open(os.path.join(opts.out, f"bucket_{slug}.txt"), "w") as f:
                f.write(prof.key_averages().table(
                    sort_by="self_cuda_time_total", row_limit=25,
                    max_name_column_width=70))
    return 0


if __name__ == "__main__":
    sys.exit(main())

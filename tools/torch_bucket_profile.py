"""Where the bucket tax of the PyTorch port's eval goes on the GPU.

    python3 tools/torch_bucket_profile.py [--out DIR]

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

PRESET = os.path.join(REPO, "cvpr2021_vspw_implement_tpu_torch", "config",
                      "presets", "vsp-resnet101dilated-ppm_deepsup_clip.yaml")
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


def main(argv=None) -> int:
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bucket_profile: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = default_cfg.clone()
    cfg.merge_from_file(PRESET)
    model = test_clip.build_model(cfg, test_clip.build_eval_clip_parser()
                                  .parse_args(["--cfg", PRESET]), "cuda")
    raft = tc_cal.build_raft(tc_cal.build_parser().parse_args(
        ["--dataroot", "", "--predroot", "", "--allow_random_raft",
         "--raft_iters", "20"]), "cuda")
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(rng.standard_normal((H, W, 3), np.float32))
    img = frame.cuda().permute(2, 0, 1)[None]
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
            slug = re.sub(r"\W+", "_", name).strip("_")
            with open(os.path.join(opts.out, f"bucket_{slug}.txt"), "w") as f:
                f.write(prof.key_averages().table(
                    sort_by="self_cuda_time_total", row_limit=25,
                    max_name_column_width=70))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where a train step of the PyTorch port spends its time on the GPU.

    python3 tools/torch_step_profile.py [--method ETC|clip_psp|our_warp|propnet]
        [--out DIR]

Runs the trainer itself (``train_clip.main``: its parser, data loader and
``train_step``) with the R101 preset at the recipe's shape (crop 479, batch
2, 124 classes, f32 without TF32; seeded random weights) on synthetic
480x853 videos for six steps.  Steps 1-2 warm up; steps 3-4 are timed on the
host's clock around a synchronised ``train_step``; steps 5-6 run under
``torch.profiler``.  Prints the untraced and the traced step's wall time, the
device's busy time per traced step (the sum of its kernels' device times),
and the kernels that take the most device time; writes the profiler's table
to ``DIR`` (the fixture and the checkpoint go to ``build/profile``).

Needs a CUDA device.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cvpr2021_vspw_implement_tpu_torch import train_clip  # noqa: E402
from cvpr2021_vspw_implement_tpu_torch.data import \
    make_synthetic_vspw  # noqa: E402

PRESET = os.path.join(REPO, "cvpr2021_vspw_implement_tpu_torch", "config",
                      "presets", "vsp-resnet101dilated-ppm_deepsup_clip.yaml")
FLAGS = {"ETC": ["--clip_num", "2", "--dilation_num", "0", "--st_weight",
                 "0.1"],
         "clip_psp": ["--clip_num", "4", "--dilation2", "3,6,9"],
         # the bench's our_warp_train row, and PropNet at the same r
         "our_warp": ["--clip_num", "4", "--max_distances", "10",
                      "--allsup", "true"],
         "propnet": ["--clip_num", "4", "--max_distances", "10"]}


def main(argv=None) -> int:
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="ETC", choices=sorted(FLAGS))
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_step_profile: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())

    # 4 videos of 12 frames (the 3,6,9 offsets need an anchor with 9 frames
    # after it), batch 2: two steps an epoch, three epochs
    work = os.path.join(REPO, "build", "profile")
    root = os.path.join(work, "vspw_train")
    make_synthetic_vspw(root, 4, 12, (480, 853), 124, seed=1,
                        splits=("train",))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    step, walls = train_clip.train_step, []

    def watched_step(*args):
        if len(walls) == 4:
            prof.start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(*args)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        if len(walls) == 6:
            prof.stop()
        return metrics

    train_clip.train_step = watched_step
    try:
        train_clip.main([
            "--cfg", PRESET, "--dataroot", root, "--num_class", "124",
            "--method", opts.method, *FLAGS[opts.method], "--batchsize", "2",
            "--cropsize", "479", "--lr", "0.002", "--totalepoch", "3",
            "--saveroot", os.path.join(work, "ckpt"), "--seed", "0",
            "DIR", os.path.join(work, "cfg")])
    finally:
        train_clip.train_step = step
    if len(walls) != 6:
        raise SystemExit(f"expected 6 steps, ran {len(walls)}")

    # kernels only: an operator's row repeats its kernels' device time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    untraced, traced = sum(walls[2:4]) / 2, sum(walls[4:6]) / 2
    print(f"{opts.method} step: {untraced:.1f} ms untraced (steps 3-4), "
          f"{traced:.1f} ms under the profiler (steps 5-6)")
    if not events:
        print("the profiler reported no device time on this machine")
        return 0
    busy = sum(e.self_device_time_total for e in events) / 2e3
    print(f"device busy {busy:.1f} ms per traced step: {busy / untraced:.3f} "
          f"of the untraced step's wall time, {busy / traced:.3f} of the "
          "traced step's")
    os.makedirs(opts.out, exist_ok=True)
    with open(os.path.join(opts.out,
                           f"step_profile_{opts.method}.txt"), "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=25,
            max_name_column_width=70))
    events.sort(key=lambda e: -e.self_device_time_total)
    print("kernels by device time (ms per step, calls per step):")
    for e in events[:14]:
        print(f"  {e.self_device_time_total / 2e3:8.2f}  {e.count // 2:5d}  "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

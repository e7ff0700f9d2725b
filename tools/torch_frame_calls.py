"""Call-by-call wall time of a per-frame eval on the GPU (by default
HRNetV2-W48 + C1).

    python3 tools/torch_frame_calls.py [--order exact,bucketed,exact,...]
        [--preset vsp-resnet101-upernet.yaml] [KEY VALUE ...]

Builds the seeded model of ``--preset`` (a file of the port's
config/presets, default ``vsp-hrnetv2.yaml``; trailing ``KEY VALUE`` pairs
override it, e.g. ``MODEL.arch_encoder resnext101``; 124 classes) and one
480x853 frame (contiguous NCHW), then runs ``test.frame_pred`` in the
given order of phases, each a few calls, timing every call on the host
clock with a synchronise before and after, and prints each phase's
per-call milliseconds.  Phases: ``exact`` (20 calls at 480x853),
``bucketed`` (5 calls in the 480x896 bucket), ``new`` (a second model,
seeded the same, 20 exact calls), ``empty`` (``torch.cuda.empty_cache()``,
then 10 exact calls); and, with no call of the model: ``matmul`` (one
small ``torch.matmul`` on the card), ``band_zero`` (one B6 launch on a
small tensor: the kernels' library loaded), ``resize_rt`` (one
``resize_bilinear_rt`` of a small tensor).  ``--cudnn_benchmark`` sets
``torch.backends.cudnn.benchmark``.  It shows how the exact path's time
depends on what ran before it in the process.  Needs a CUDA device; prints
the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cvpr2021_vspw_implement_tpu_torch import (  # noqa: E402
    test as frame_test)
from cvpr2021_vspw_implement_tpu_torch.config import (  # noqa: E402
    cfg as default_cfg)
from cvpr2021_vspw_implement_tpu_torch.ops.band_zero import (  # noqa: E402
    band_zero)
from cvpr2021_vspw_implement_tpu_torch.ops.masked import (  # noqa: E402
    resize_bilinear_rt)

PRESETS = os.path.join(REPO, "cvpr2021_vspw_implement_tpu_torch", "config",
                       "presets")
CALLS = {"exact": 20, "bucketed": 5, "new": 20, "empty": 10}


def build(preset, overrides):
    path = os.path.join(PRESETS, preset)
    cfg = default_cfg.clone()
    cfg.merge_from_file(path)
    cfg.merge_from_list(overrides)
    return frame_test.build_model(cfg, frame_test.build_eval_parser()
                                  .parse_args(["--cfg", path]), "cuda")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--order", default="exact,bucketed,exact,new,empty")
    ap.add_argument("--cudnn_benchmark", action="store_true")
    ap.add_argument("--preset", default="vsp-hrnetv2.yaml")
    ap.add_argument("overrides", nargs=argparse.REMAINDER)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_frame_calls: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__}, cuDNN {torch.backends.cudnn.version()}"
          f"; {opts.preset} {' '.join(opts.overrides)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = opts.cudnn_benchmark
    model = build(opts.preset, opts.overrides)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 3, 480, 853), np.float32))
    x = x.cuda()
    for phase in opts.order.split(","):
        if phase in ("matmul", "band_zero", "resize_rt"):
            t = torch.ones(1, 4, 8, 8, device="cuda")
            with torch.inference_mode():
                if phase == "matmul":
                    torch.matmul(t[0, 0], t[0, 0])
                elif phase == "band_zero":
                    band_zero(t, 6, 5)
                else:
                    resize_bilinear_rt(t, (16, 16), (6, 5), (12, 10))
            torch.cuda.synchronize()
            print(f"{phase}: one call on a [1, 4, 8, 8] tensor")
            continue
        if phase == "new":
            del model
            model = build(opts.preset, opts.overrides)
        if phase == "empty":
            torch.cuda.empty_cache()
        bucket = 64 if phase == "bucketed" else 0
        ms = []
        with torch.inference_mode():
            for _ in range(CALLS[phase]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                frame_test.frame_pred(model, x, bucket)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
        print(f"{phase}: {len(ms)} calls, ms each "
              f"{[round(v, 1) for v in ms]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

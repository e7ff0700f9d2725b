"""The clip trainer's loop with its batches made serially against the
threaded input pipeline, on one GPU.

    python3 tools/torch_loader_bench.py [--methods clip_psp propnet]
        [--steps 6] [--out DIR]

For each method, ``train_clip``'s loop (its model, loss, optimizer and
``train_step``; R101 preset, crop 479, batch 2, 124 classes, f32 without
TF32, seeded random weights) over synthetic 480x853 JPEG videos, one epoch
of ``--steps`` steps a run, in the order serial, prefetched, prefetched,
serial:

* serial: the dataset iterated in the loader's order on the calling thread,
  each batch collated and copied to the card (blocking) before its step;
* prefetched: ``PrefetchLoader`` (one worker thread: PIL decode, the native
  normalize) into pinned memory, then ``device_prefetch`` (copies on a side stream,
  ``TPU.prefetch`` = 2 ahead), as ``train_clip`` runs.

Both give the same batches.  A step's data wait is the host time from the
end of the step before (its loss read back) to its batch on the card, the
trainer's ``data_time``; its wall time runs from the same point to its own
loss read back.  The first step of a run is left out (the worker starts,
cuDNN picks its engines).  Prints the card's name and power limit, a line a
run and one JSON line; ``--out`` also gets the JSON.  The fixture stays in
``build/loader_bench``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cvpr2021_vspw_implement_tpu_torch.config import cfg as default_cfg  # noqa: E402,E501
from cvpr2021_vspw_implement_tpu_torch.config.args import (  # noqa: E402
    build_train_clip_parser, postprocess_args)
from cvpr2021_vspw_implement_tpu_torch.data import (  # noqa: E402
    ClipDataset, LongClipDataset, PrefetchLoader, make_synthetic_vspw)
from cvpr2021_vspw_implement_tpu_torch.methods import (  # noqa: E402
    LONGCLIP_METHODS, build_method, get_collate)
from cvpr2021_vspw_implement_tpu_torch.models.layers import (  # noqa: E402
    init_weights, set_dropout_generator)
from cvpr2021_vspw_implement_tpu_torch.parallel import (  # noqa: E402
    create_clip_optimizer, device_prefetch, pinned_collate, to_device,
    train_step)

PRESET = os.path.join(REPO, "cvpr2021_vspw_implement_tpu_torch", "config",
                      "presets", "vsp-resnet101dilated-ppm_deepsup_clip.yaml")
FLAGS = {"clip_psp": ["--clip_num", "4", "--dilation2", "3,6,9"],
         "propnet": ["--clip_num", "4", "--max_distances", "10"]}
BATCH, SEED = 2, 0


def fixture(steps: int) -> str:
    """``steps`` batches of 2 clips: 2 * steps videos of 12 480x853 frames
    (the 3,6,9 offsets need an anchor with 9 frames after it)."""
    root = os.path.join(REPO, "build", "loader_bench", f"vspw_{steps}")
    if not os.path.exists(os.path.join(root, "train.txt")):
        make_synthetic_vspw(root, BATCH * steps, 12, (480, 853), 124, seed=1,
                            splits=("train",))
    return root


def serial_batches(dataset, collate, device):
    """The loader's batches, made on the calling thread."""
    order = PrefetchLoader(dataset, BATCH, collate, seed=SEED)
    for idxs in order._index_batches():
        yield to_device(collate([dataset[int(i)] for i in idxs]), device)


def prefetched_batches(dataset, collate, device, depth):
    loader = PrefetchLoader(dataset, BATCH, pinned_collate(collate, device),
                            seed=SEED, prefetch=depth)
    yield from device_prefetch(loader, device, depth)


def run_method(method: str, root: str, steps: int) -> dict:
    """The four runs of ``method``: {"serial": [...], "prefetched": [...]},
    each run's data waits and wall times (ms) of steps 2..steps."""
    device = torch.device("cuda")
    args = build_train_clip_parser().parse_args(
        ["--cfg", PRESET, "--dataroot", root, "--num_class", "124",
         "--method", method, *FLAGS[method], "--batchsize", str(BATCH),
         "--cropsize", "479", "--lr", "0.002"])
    postprocess_args(args)
    cfg = default_cfg.clone()
    cfg.merge_from_file(PRESET)
    model, loss_fn = build_method(method, cfg, args)
    init_weights(model, torch.Generator().manual_seed(SEED))
    model.to(device).train()
    set_dropout_generator(model,
                          torch.Generator(device=device).manual_seed(SEED))
    optimizer, scheduler = create_clip_optimizer(
        model, lr=args.lr, max_iters=1000, momentum=cfg.TRAIN.beta1,
        weight_decay=args.weight_decay, lr_pow=cfg.TRAIN.lr_pow)
    ds_cls = LongClipDataset if method in LONGCLIP_METHODS else ClipDataset
    collate = get_collate(method, args.clip_num)
    out = {"serial": [], "prefetched": []}
    for mode in ("serial", "prefetched", "prefetched", "serial"):
        dataset = ds_cls(args, "train", seed=SEED)
        batches = serial_batches(dataset, collate, device) \
            if mode == "serial" else prefetched_batches(
                dataset, collate, device, cfg.TPU.prefetch)
        torch.cuda.synchronize()
        waits, walls = [], []
        tic = time.perf_counter()
        for batch in batches:
            ready = time.perf_counter()
            float(train_step(model, optimizer, scheduler, batch,
                             loss_fn)["loss"])
            end = time.perf_counter()
            waits.append(1e3 * (ready - tic))
            walls.append(1e3 * (end - tic))
            tic = end
        if len(waits) != steps:
            raise RuntimeError(f"{method} {mode}: {len(waits)} steps, "
                               f"expected {steps}")
        run = {"data_wait_ms": waits[1:], "step_ms": walls[1:]}
        out[mode].append(run)
        print(f"{method} {mode}: data wait {np.mean(waits[1:]):.1f} ms a "
              f"step (max {max(waits[1:]):.1f}; the first step "
              f"{waits[0]:.1f}), step wall time {np.mean(walls[1:]):.1f} ms "
              f"a step, host clock, steps 2-{steps}", flush=True)
    return out


def run(methods=("clip_psp", "propnet"), steps: int = 6) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    root = fixture(steps)
    return {m: run_method(m, root, steps) for m in methods}


def summary(result: dict) -> dict:
    """Per method and mode: the mean data wait and step wall time (ms) over
    both runs."""
    return {m: {mode: {key: float(np.mean([v for r in runs for v in r[key]]))
                       for key in ("data_wait_ms", "step_ms")}
                for mode, runs in modes.items()}
            for m, modes in result.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--methods", nargs="+", default=["clip_psp", "propnet"],
                    choices=sorted(FLAGS))
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out", default="")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_loader_bench: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    result = run(opts.methods, opts.steps)
    line = json.dumps({"summary": summary(result), "runs": result})
    print(line)
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        with open(os.path.join(opts.out, "torch_loader_bench.json"), "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

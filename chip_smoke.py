"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. prints the card (name, and name and power limit from nvidia-smi);
2. builds the CUDA kernels from ``kernels/csrc`` with nvcc (in parallel);
3. holds each kernel against its plain PyTorch version at the main path's
   shapes (TC at VSPW-480p: 60x107 RAFT features) with TF32 off, and times
   kernel, plain version, bound and the PyTorch yardstick;
4. drives the main path through the user entry points: TCB-PSP streaming
   eval (``test_clip``, seeded random ResNet-101-dilated ClipPSP, fc_dim
   2048, 124 classes) over a synthetic 10-frame 480x853 video with PNG
   dumps, then the TC metric (``tc_cal``, seeded random RAFT, 20
   refinements) over those PNGs; the kernel launch counts are zeroed just
   before each path and read just after;
5. checks the outputs (PNG shapes and classes, finite mIoU, VC, TC) and that
   the card and the CPU agree on a small input;
6. prints the kernels' JSON line and, last, the device JSON line.

It exits non-zero without CUDA, on any failed phase, or when run outside
a checkout of the repository.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores


def cuda_ms(fn, n=20, warm=3):
    """Mean device time of ``fn`` over ``n`` back-to-back calls (CUDA
    events, after ``warm`` calls)."""
    import torch
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


def grid_sample_lookup(pyramid, coords, r=4):
    """The reference's per-level lookup (RAFT_core/corr.py:28-50 with
    utils.py:58-73): ``F.grid_sample`` on [B*P, 1, Hl, Wl] planes.  Timed
    as the PyTorch yardstick of the corr-lookup kernel; the port never
    calls it."""
    import torch
    import torch.nn.functional as F
    b, _, h1, w1 = coords.shape
    d = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1)
    centroid = coords.permute(0, 2, 3, 1).reshape(b * h1 * w1, 1, 1, 2)
    outs = []
    for i, corr in enumerate(pyramid):
        hl, wl = corr.shape[2:]
        xy = centroid / 2 ** i + delta.view(1, 2 * r + 1, 2 * r + 1, 2)
        grid = torch.stack([2 * xy[..., 0] / (wl - 1) - 1,
                            2 * xy[..., 1] / (hl - 1) - 1], -1)
        s = F.grid_sample(corr.reshape(b * h1 * w1, 1, hl, wl), grid,
                          align_corners=True)
        outs.append(s.view(b, h1 * w1, -1))
    return torch.cat(outs, -1).permute(0, 2, 1).reshape(b, -1, h1, w1)


def lookup_bytes(pyramid, coords, r=4):
    """Bytes the lookup must move for these coords: the in-range values of
    each query's (2r+2)^2 patch per level, the coords and the output."""
    import torch
    b, _, h1, w1 = coords.shape
    c = coords.reshape(b, 2, -1)
    n = 0
    for i, corr in enumerate(pyramid):
        hl, wl = corr.shape[2:]

        def span(v, size):
            lo = torch.floor(v / 2 ** i) - r
            return (torch.clamp(lo + 2 * r + 1, max=size - 1)
                    - torch.clamp(lo, min=0) + 1).clamp(min=0)

        n += int((span(c[:, 0], wl) * span(c[:, 1], hl)).sum().item())
    out = b * len(pyramid) * (2 * r + 1) ** 2 * h1 * w1
    return 4 * (n + c.numel() + out)


def check_kernels(torch):
    """Kernel vs plain at the TC shape; returns the kernels' JSON rows
    (launches filled in later)."""
    from cvpr2021_vspw_implement_tpu_torch.models.raft.corr import \
        build_corr_pyramid
    from cvpr2021_vspw_implement_tpu_torch.models.raft.raft import \
        coords_grid
    from cvpr2021_vspw_implement_tpu_torch.ops.corr_lookup import (
        lookup_corr_pyramid, lookup_corr_pyramid_plain)
    from cvpr2021_vspw_implement_tpu_torch.ops.sep_gru import (
        sep_conv_gru_pass, sep_conv_gru_pass_plain)

    g = torch.Generator(device="cuda").manual_seed(0)
    h, w = 60, 107
    p = h * w
    f1 = torch.randn(1, 256, h, w, device="cuda", generator=g)
    f2 = torch.randn(1, 256, h, w, device="cuda", generator=g)
    pyr = build_corr_pyramid(f1, f2)
    coords = coords_grid(1, h, w, "cuda") + 8 * torch.randn(
        1, 2, h, w, device="cuda", generator=g)
    coords[:, 0, :3] = -20.0                   # rows of far-out-of-range taps
    coords[:, 1, -3:] = h + 15.5
    coords = coords.contiguous()
    got = lookup_corr_pyramid(pyr, coords)
    torch.cuda.synchronize()
    want = lookup_corr_pyramid_plain(pyr, coords)
    lib = grid_sample_lookup(pyr, coords)
    err1 = (got - want).abs().max().item()
    print(f"corr_lookup: max |kernel - plain| = {err1:.3e} (limit 1e-5); "
          f"|grid_sample - plain| = {(lib - want).abs().max().item():.3e}")
    if not err1 <= 1e-5:
        raise SystemExit("corr_lookup kernel disagrees with its plain version")
    ops1 = 11 * 4 * 81 * p                     # 4 taps: weights and blend
    k1 = {
        "name": "corr_lookup", "route": "cuda",
        "source": "cvpr2021_vspw_implement_tpu_torch/kernels/csrc/"
                  "corr_lookup.cu",
        "replaces": "cvpr2021_vspw_implement_tpu/ops/pallas/corr.py:234",
        "max_abs_err": err1,
        "plain_ms": cuda_ms(lambda: lookup_corr_pyramid_plain(pyr, coords)),
        "ms": cuda_ms(lambda: lookup_corr_pyramid(pyr, coords)),
        "library_ms": cuda_ms(lambda: grid_sample_lookup(pyr, coords)),
    }
    t_bytes = lookup_bytes(pyr, coords) / HBM_BYTES_PER_S
    t_ops = ops1 / F32_FLOP_PER_S
    k1["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    k1["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"

    hd, cx = 128, 256
    hh = torch.tanh(torch.randn(1, hd, h, w, device="cuda", generator=g))
    x = torch.randn(1, cx, h, w, device="cuda", generator=g)
    errs, times = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    for axis in (0, 1):
        wzr = 0.03 * torch.randn(5, hd + cx, 2 * hd, device="cuda",
                                 generator=g)
        bzr = 0.1 * torch.randn(2 * hd, device="cuda", generator=g)
        wq = 0.03 * torch.randn(5, hd + cx, hd, device="cuda", generator=g)
        bq = 0.1 * torch.randn(hd, device="cuda", generator=g)
        args = (hh, x, wzr, bzr, wq, bq, axis)
        got = sep_conv_gru_pass(*args)
        torch.cuda.synchronize()
        errs.append((got - sep_conv_gru_pass_plain(*args)).abs().max().item())
        times["plain_ms"] += cuda_ms(lambda: sep_conv_gru_pass_plain(*args))
        times["ms"] += cuda_ms(lambda: sep_conv_gru_pass(*args))
        # the yardstick: the same F.conv2d composition with PyTorch's
        # default cuDNN settings (TF32 allowed)
        torch.backends.cudnn.allow_tf32 = True
        times["library_ms"] += cuda_ms(
            lambda: sep_conv_gru_pass_plain(*args))
        torch.backends.cudnn.allow_tf32 = False
    err2 = max(errs)
    print(f"sep_gru: max |kernel - plain| = {err2:.3e} over both axes "
          "(limit 1e-4)")
    if not err2 <= 1e-4:
        raise SystemExit("sep_gru kernel disagrees with its plain version")
    flops = 2 * p * 5 * (hd + cx) * 3 * hd
    nbytes = 4 * (p * (hd + cx + hd) + 5 * (hd + cx) * 3 * hd + 3 * hd)
    t_ops, t_bytes = flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    k2 = {
        "name": "sep_gru", "route": "cuda",
        "source": "cvpr2021_vspw_implement_tpu_torch/kernels/csrc/sep_gru.cu",
        "replaces": "cvpr2021_vspw_implement_tpu/ops/pallas/gru.py:178",
        "max_abs_err": err2,
        # per pass, the mean of the two axes
        "ms": times["ms"] / 2, "plain_ms": times["plain_ms"] / 2,
        "library_ms": times["library_ms"] / 2,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    for k in (k1, k2):
        print(f"{k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f}"
              f" ms, library {k['library_ms']:.4f} ms, bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']})")
    return [k1, k2]


def small_input_agreement(torch):
    """The card (kernels) and the CPU (plain versions) on one small input:
    RAFT flow (one refinement, atol 1e-3 px) and ClipPSP logits (relative
    1e-3 of their range; cuDNN and the CPU sum in other orders)."""
    from cvpr2021_vspw_implement_tpu_torch.models.clip_psp import ClipPSP
    from cvpr2021_vspw_implement_tpu_torch.models.layers import init_weights
    from cvpr2021_vspw_implement_tpu_torch.models.raft import RAFT
    from cvpr2021_vspw_implement_tpu_torch.models.resnet import build_encoder

    g = torch.Generator().manual_seed(1)
    raft = RAFT(iters=1)
    init_weights(raft, torch.Generator().manual_seed(2))
    raft.eval()
    im1 = 255 * torch.rand(1, 3, 64, 96, generator=g)
    im2 = torch.roll(im1, (2, 3), (2, 3))
    with torch.inference_mode():
        cpu = raft(im1, im2)[0]
        gpu = raft.cuda()(im1.cuda(), im2.cuda())[0].cpu()
    err = (cpu - gpu).abs().max().item()
    print(f"RAFT flow card vs CPU: max |diff| = {err:.3e} px (limit 1e-3)")
    if not err <= 1e-3:
        raise SystemExit("RAFT on the card disagrees with the CPU")

    model = ClipPSP(build_encoder("resnet18dilated"), 124, fc_dim=512)
    init_weights(model, torch.Generator().manual_seed(3))
    model.eval()
    imgs = torch.randn(4, 1, 3, 64, 96, generator=g)
    with torch.inference_mode():
        cpu = model(imgs)[0]
        gpu = model.cuda()(imgs.cuda())[0].cpu()
    rel = ((cpu - gpu).abs().max() / cpu.abs().max()).item()
    print(f"ClipPSP logits card vs CPU: max |diff| / max |logit| = "
          f"{rel:.3e} (limit 1e-3)")
    if not rel <= 1e-3:
        raise SystemExit("ClipPSP on the card disagrees with the CPU")


def main() -> int:
    import numpy as np
    import torch
    from PIL import Image

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from cvpr2021_vspw_implement_tpu_torch import kernels, tc_cal, test_clip
    from cvpr2021_vspw_implement_tpu_torch.data import make_synthetic_vspw
    from cvpr2021_vspw_implement_tpu_torch.ops.corr_lookup import \
        lookup_corr_pyramid
    from cvpr2021_vspw_implement_tpu_torch.ops.sep_gru import \
        sep_conv_gru_pass

    wrappers = {"corr_lookup": lookup_corr_pyramid,
                "sep_gru": sep_conv_gru_pass}
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    logs = kernels.build()
    for name in kernels.SIGNATURES:
        kernels.load(name)
    seconds = time.perf_counter() - t0
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    with open(os.path.join(kernels.BUILD_DIR, "build.log"), "w") as f:
        f.write("\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    print(f"kernels built in {seconds:.2f} s: {sorted(kernels.SIGNATURES)}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = check_kernels(torch)
    small_input_agreement(torch)

    work = os.path.join(REPO, "build", "chip_smoke")
    root, preds = os.path.join(work, "vspw"), os.path.join(work, "preds")
    n_frames, hw, k = 10, (480, 853), 124
    make_synthetic_vspw(root, 1, n_frames, hw, k, seed=0)

    def reset():
        for fn in wrappers.values():
            fn.launches = 0

    reset()
    t0 = time.perf_counter()
    metrics, _ = test_clip.main([
        "--cfg", os.path.join(REPO, "cvpr2021_vspw_implement_tpu_torch",
                              "config", "presets",
                              "vsp-resnet101dilated-ppm_deepsup_clip.yaml"),
        "--dataroot", root, "--num_class", str(k), "--method", "clip_psp",
        "--is_save", "--saveroot", preds, "--seed", "0"])
    eval_s = time.perf_counter() - t0
    eval_counts = {n: fn.launches for n, fn in wrappers.items()}
    print(f"TCB-PSP streaming eval (R101, 480x853, {n_frames} frames): "
          f"{1e3 * eval_s / n_frames:.1f} ms/frame including the first "
          f"frame; mIoU {metrics['mIoU']:.6f} VC {metrics['VC']:.6f}; "
          f"kernel launches {eval_counts}")

    reset()
    t0 = time.perf_counter()
    tc = tc_cal.main([
        "--dataroot", root, "--predroot", preds, "--num_class", str(k),
        "--allow_random_raft", "--raft_iters", "20", "--seed", "0"])
    tc_s = time.perf_counter() - t0
    tc_counts = {n: fn.launches for n, fn in wrappers.items()}
    print(f"TC (RAFT 20 iters, {n_frames - 1} pairs): "
          f"{1e3 * tc_s / (n_frames - 1):.1f} ms/pair; TC {tc:.6f}; "
          f"kernel launches {tc_counts}")

    names = sorted(os.listdir(os.path.join(preds, "video_000")))
    if len(names) != n_frames:
        raise SystemExit(f"expected {n_frames} prediction PNGs, got "
                         f"{len(names)}")
    for name in names:
        pred = np.asarray(Image.open(os.path.join(preds, "video_000", name)))
        if pred.shape != hw or pred.max() >= k:
            raise SystemExit(f"bad prediction {name}: {pred.shape}, "
                             f"max {pred.max()}")
    if not all(np.isfinite(v) for v in (metrics["mIoU"], metrics["VC"], tc)):
        raise SystemExit("non-finite metric")
    for row in rows:
        row["launches"] = eval_counts[row["name"]] + tc_counts[row["name"]]
        if row["launches"] <= 0:
            raise SystemExit(f"{row['name']} was not launched on the main "
                             "path")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: r[key] for key in keys}
                                  for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

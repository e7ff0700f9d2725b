"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. prints the card (name, and name and power limit from nvidia-smi);
2. builds the CUDA kernels from ``kernels/csrc`` with nvcc (in parallel)
   and prints ptxas's registers, spills and shared memory of the
   tensor-core kernels (B2-B5); builds the native host ops (``native``,
   g++) and prints which path they took, and their time beside numpy's on
   the fixture's frames (it fails if g++ is present and ``hostops`` did
   not build, or if they are not bitwise numpy's);
3. holds each kernel against its plain PyTorch version at the main paths'
   shapes (corr lookup: TC at VSPW-480p, 60x107 RAFT features; GRU pass:
   60x107 and the 60x112 bucket;
   corr lookup, motion encoder and GRU + flow head: the 479 training crop,
   batch 2, 60x60; the three local aggregations of our_warp: 1x60x107,
   128-d distances, 256-d values, r = 10, and in the bucket, 60x112 with
   the valid size 60x107 (also against the launch on the crop, and its band
   zero); sigmoid at our_warp_merge's 256-d distances, exact and bucketed;
   B5's backward, ``local_agg_bwd.cu``, at the training shape 2x60x60, r =
   10: sigmoid and softmax at Cd 128, sigmoid at Cd 256, against the plain
   backward in float64, timed beside ``.backward()`` through the unfold
   formulation, their query-side and key-side kernels apart with their
   tensor-core route; nearest bitwise the plain backward at Cd 128 and at a
   crowded index (one key picked 441 times an image), beside one
   ``scatter_add_``;
   the band re-zero: R101 features
   and C5 in the 480x896 bucket, a correlation-pyramid level, a rows-only
   and a no-band case, bitwise)
   with TF32 off, and times kernel, plain version, bound and the PyTorch
   yardstick (CUDA events over back-to-back calls); the corr lookup (B1),
   the band re-zero (B6) and nearest's backward, whose launches are
   shorter than their host enqueue, on three clocks instead
   (kernels/timing.py): device time a
   launch from a replayed CUDA graph (their ``ms``), the profiler's device
   time, and the host's enqueue a call, for the kernel and its yardsticks,
   beside the bound and the 32-byte sectors the call must touch; then
   times one refinement of RAFT's update block by its fused route (B2 + B3)
   and its unfused one (cuDNN + B4 + cuDNN) at 2x60x60 and 1x60x107;
4. drives the main paths through the user entry points, the kernel launch
   counts zeroed just before each path and read just after:
   a. TCB-PSP streaming eval (``test_clip --eval_policy exact --width_bucket
      0``, seeded random ResNet-101-dilated ClipPSP, fc_dim 2048, 124
      classes) over a synthetic 10-frame 480x853 video with PNG dumps;
   b. the TC metric (``tc_cal --width_bucket 0``, seeded random RAFT with
      the flow head scaled to a trained-like step, 20 refinements) over
      those PNGs;
   a'. the same eval at the CLI's default, width-bucketed (480x853 padded to
      the 480x896 bucket, the band re-zeroed by its kernel at a count derived
      from the model), against a's PNGs and, in a separate pass, a's logits;
   b'. the TC metric at its default, bucketed, over a''s PNGs; then the TC
      check: each pair's RAFT flow bucketed against exact on the pair's
      size after the first refinement (``tc_flow_check``), the code as
      shipped (sound), exact against exact with the corr lookup's plain
      version (control, a change of rounding order) and bucketed with the
      flow's band left unzeroed (a planted fault, which must fail);
   c. the clip trainer (``train_clip``) on synthetic 480x853 videos, the same
      R101 preset, crop 479, batch 2: ``--method clip_psp`` (4 frames,
      offsets 3,6,9), then ``--method ETC`` (2 frames, RAFT at 20
      refinements), four steps each; then the window methods' training,
      four steps each at clip_num 4, r = 10: ``--method our_warp`` with
      ``--allsup``, with ``--distsoftmax`` and with ``--distnearest`` (3 B5
      forward and 3 backward launches a step), ``--method our_warp_merge``
      (1 and 1, 256-d distances) and ``--method propnet`` (none);
   d. the window eval path over the 10-frame video, seeded random R101
      models, clip_num 4, max_distances 10: ``test_clip --method our_warp``
      in each mode (sigmoid, ``--distsoftmax``, ``--distnearest``; B5 3
      times a window), ``--method ETC --clip_num 2``, ``--method propnet``
      and ``--method our_warp_merge`` (B5 once a window), each at exact
      shapes (``--width_bucket 0``) and then at the CLI's default,
      bucketed in 480x896 (B5 with the valid size, B6 at counts derived
      from the models); each bucketed run against its exact run (logits
      within 1e-3 of the largest, PNGs equal off near-ties), host-clock ms
      a window printed;
   f. the per-frame eval CLI (``test``, seeded random R101 ``ppm_deepsup``,
      fc_dim 2048, 124 classes) over the 10-frame video, exact
      (``--width_bucket 0``) and then bucketed in 480x896 (B6 at a count
      derived from the model), PNGs compared as the clip phases compare
      them, a frame's forward timed on CUDA events;
   g. the per-frame trainer (``train``, the same preset, batch 8, crop 479,
      ``--multi_scale True``, 4 steps), then the clip trainer's loop for
      clip_psp and propnet with its batches made serially against the
      prefetch loader (tools/torch_loader_bench.py); every train phase
      prints its data wait;
   h. the TCB-OCR and NetWarp eval CLIs over the 10-frame video, seeded
      random R101 models (TCB-OCR on the OCR preset), each exact and then
      bucketed in 480x896: ``test_clip --method clip_ocr`` streaming, then
      ``--use_memory True`` (the run script's eval: the window path with
      the ring of contexts), ``--method netwarp`` and ``netwarp_ocr``
      (pairs streamed, RAFT at 20 refinements: B1 at 20 and B4 at 40 a
      pair); B6 at counts derived from the models; each bucketed run held
      against its exact run as in d; then NetWarp's refined flow bucketed
      against exact after RAFT's first refinement, and with FlowCNN
      unmasked, a planted fault that must fail (the blend weights start at
      0, so the predictions do not read the warp at the seeded init);
   i. the clip trainer for ``clip_ocr`` (4 frames, offsets 3,6,9),
      ``netwarp``, ``netwarp_ocr`` and ``etc_ocr`` (2 frames, RAFT at 20
      refinements: B1, B2 and B3 at 20 a step), crop 479, batch 2, four
      steps each;
   j. the TDNet eval CLI (``test_clip --method tdnet``, four seeded
      ResNet-18-dilated paths at crop 479, the LayerNorm maps live and the
      attention's logits a few units) streaming a 12-frame 480x853 video,
      exact and then bucketed in 480x896 (B6 at a count derived from the
      model), held against each other as in d; a planted fault, the token
      mask off in the bucketed attention, must fail that check;
   k. the Non-local 3D eval CLI (``--method nonlocal3d --clip_num 3``,
      ``test_all``, seeded R101, its BatchNorm statistics calibrated on the
      first window and the block's residual scale live) over
      the 10-frame video, exact and then bucketed, each window frame's
      logits and the PNGs held; a planted fault, the dot normaliser
      counting the padded positions, must fail that check;
   l. the clip trainer for ``tdnet`` (4 frames, ``pos_id`` rotating) and
      ``nonlocal3d`` (3 frames), crop 479, batch 2, four steps each;
   m. the per-frame eval CLI with HRNetV2-W48 + C1 (``vsp-hrnetv2.yaml``,
      seeded, its BatchNorm statistics calibrated on the first frame) over
      the 10-frame video, exact and then bucketed in 480x896 (B6 at a count
      derived from the model: the input of each of the trunk's 265
      spatial convs, its output, C1's input), held against each other as
      in f; a planted fault, the fusion upsamples on the padded size, must
      fail that check;
   n. ``test_clip --method hrnetv2_clip --clip_num 4`` (calibrated on the
      first window) over the video with its frames made to differ, exact
      and then bucketed, held as d holds the window methods, and
      TimeAtten's blend weights within 1e-5 of exact; a planted fault,
      TimeAtten pooling the padded grid with the stem's band in it, must
      fail those checks;
   o. the per-frame trainer with ``vsp-hrnetv2.yaml`` and
      ``vsp-resnet101dilated-ocr_deepsup.yaml``, crop 479, batch 2, four
      steps each; then the per-frame ``ocrnet_deepsup`` eval (seeded R101),
      exact and bucketed, held as f;
   p. the remaining per-frame baselines, each seeded with its BatchNorm
      statistics calibrated: R101 UPerNet (output stride 32), R101-dilated
      DeepLabV3+ and Non-local 2D (its residual scale live),
      MobileNetV2-dilated + C1 with deep supervision and ResNeXt-101 +
      UPerNet: the per-frame eval CLI exact and then bucketed (B6 at a
      count derived from each model), held as f, with a planted fault each
      for UPerNet (its top-down resize on the padded size) and DeepLab (its
      image pool over the padded grid) that must fail that check; then
      the per-frame trainer, crop 479, batch 2, four steps each;
   q. the per-frame trainer's restart and data flags (R101 ``ppm_deepsup``,
      crop 479, batch 2, 2 epochs of 4 steps over 8 frames): the run
      uninterrupted, and again (the control); the same run as a child
      process that gets a real SIGTERM while it runs step 6 and exits 0
      with ``preempt_6.pth``; ``--resume`` from it, its final checkpoint
      bitwise the uninterrupted run's (every run under deterministic
      algorithms; the control's gap printed); two planted faults, the
      resume without the scheduler's and
      without the dropout generator's state, that must fail that check;
      ``--usetwodata``, ``--refrng`` and ``--profile_dir`` (a Chrome trace
      with cuDNN's kernels), 4 steps each, with their data wait;
      checkpoint size, save and load time, the profiler's overhead;
   r. ``demo.py`` over the 10-frame video (RAFT from b's checkpoint, 20
      refinements: B1 at 20 and B4 at 40 a pair), one pair's flow on the
      card against the CPU's;
   s. ``vc_perclip --clip_num 8`` over a's PNGs;
   t. ``test_clip --torch_load`` of a's model saved as a reference fused
      ``.pth``, exact and bucketed: the PNGs of a and a';
   e. the port's bench, ``bench.main(["--quick"])`` (every row at full
      width, N = 4 frames, M = 2 windows, K = 2 steps, P = 2 pairs), which
      prints its JSON line; every key present, times and rates finite and
      positive, every mfu in (0, 1], each row's launches as its loop
      implies;
5. checks the outputs (PNG shapes and classes, finite mIoU, VC, TC and
   losses, moving head and encoder parameters, a frozen RAFT) and that the
   card and the CPU agree on small inputs, an ETC train step, an our_warp
   train step (sigmoid and softmax, through B5's backward kernels) and
   ClipWarpNet in its three modes, exact and bucketed, included;
6. reads the corr lookup again at the TC shape, beside the card's clocks
   before the checks and after the paths;
7. prints the kernels' JSON line and, last, the device JSON line.

It exits non-zero without CUDA, on any failed phase, or when run outside
a checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
# f32-accurate products on the tensor cores: 3xTF32 (three TF32 products for
# each f32 one) at a third of the dense TF32 rate, 495 TFLOP/s
TF32X3_FLOP_PER_S = 495e12 / 3


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


def lookup_sectors(pyramid, coords, r=4):
    """The 32-byte sectors of the pyramid that the lookup's patches touch at
    these coords: each in-level row segment of each query's (2r+2)^2 patch
    on each level, at the levels' own addresses."""
    import torch
    b, _, h1, w1 = coords.shape
    p = h1 * w1
    c = coords.reshape(b, 2, p)
    dev = coords.device
    plane0 = (torch.arange(b, device=dev)[:, None] * p
              + torch.arange(p, device=dev)[None])           # [B, P]
    n = 0
    for i, corr in enumerate(pyramid):
        hl, wl = corr.shape[2:]
        if hl * wl == 0:
            continue
        x0, y0 = torch.floor(c[:, 0] / 2 ** i), torch.floor(c[:, 1] / 2 ** i)
        inside = (x0 >= -5) & (x0 <= wl + 3) & (y0 >= -5) & (y0 <= hl + 3)
        xlo = (x0 - r).clamp(0, wl - 1).long()
        xhi = (x0 + r + 1).clamp(0, wl - 1).long()
        rows = (y0 - r).clamp(-2 * r - 2, hl).long()[..., None] + torch.arange(
            2 * r + 2, device=dev)                            # [B, P, 10]
        live = inside[..., None] & (rows >= 0) & (rows < hl)
        start = corr.data_ptr() % 32 + 4 * (
            plane0[..., None] * (hl * wl) + rows.clamp(0, hl - 1) * wl
            + xlo[..., None])
        end = start + 4 * (xhi - xlo + 1)[..., None] - 1
        n += int(((end // 32 - start // 32 + 1) * live).sum().item())
    return n


# the shapes the paths give the corr lookup (B1), (b, h, w, levels): TC at
# 480x853 (one pair), the ETC train step (the 479 crop padded to 480, batch
# 2), and TC's with one level, the per-level variant of the TPU kernel
# (_lookup_level_pallas, corr.py:186), which no path launches alone
LOOKUP_SHAPES = ((1, 60, 107, 4), (2, 60, 60, 4), (1, 60, 107, 1))
# the band re-zero's (B6), (label, shape, hv, wv): R101 at 480x853 in the
# 480x896 bucket (C5 and a 256-channel feature at 60x112, valid 60x107), a
# correlation-pyramid level of the TC pair, a rows-only and a no-band case;
# then HRNet's four branches (the first also DeepLab's low-level
# features), UPerNet's on the output-stride-32 R101 (C2, C5, the FPN's
# 512-channel levels at strides 4 and 16; C2's shape is also DeepLab's
# fusion convs') and MobileNetV2's widest depthwise input
BAND_SHAPES = (("C5", (1, 2048, 60, 112), 60, 107),
               ("feature", (1, 256, 60, 112), 60, 107),
               ("pyramid level", (6720, 1, 30, 56), 30, 53),
               ("rows only", (1, 256, 64, 112), 57, 112),
               ("no band", (1, 256, 60, 112), 60, 112),
               ("HRNet branch 1, DeepLab low-level", (1, 48, 120, 224), 120,
                214),
               ("HRNet branch 2", (1, 96, 60, 112), 60, 107),
               ("HRNet branch 3", (1, 192, 30, 56), 30, 54),
               ("HRNet branch 4", (1, 384, 15, 28), 15, 27),
               ("UPerNet C2, DeepLab fusion", (1, 256, 120, 224), 120, 214),
               ("UPerNet C5 (stride 32)", (1, 2048, 15, 28), 15, 27),
               ("UPerNet FPN stride 4", (1, 512, 120, 224), 120, 214),
               ("UPerNet FPN stride 16", (1, 512, 30, 56), 30, 54),
               ("MobileNetV2 depthwise input", (1, 960, 60, 112), 60, 107))


def lookup_cases(torch):
    """(shape label, pyramid, coords) at each of LOOKUP_SHAPES, seeded: RAFT's
    pyramid of random features, coords on the query grid plus N(0, 8^2) px
    with rows of far-out-of-range taps.  tools/torch_launch_bench.py times
    the same inputs."""
    from cvpr2021_vspw_implement_tpu_torch.models.raft.corr import \
        build_corr_pyramid
    from cvpr2021_vspw_implement_tpu_torch.models.raft.raft import \
        coords_grid

    g = torch.Generator(device="cuda").manual_seed(0)
    for b, h, w, levels in LOOKUP_SHAPES:
        f1 = torch.randn(b, 256, h, w, device="cuda", generator=g)
        f2 = torch.randn(b, 256, h, w, device="cuda", generator=g)
        coords = coords_grid(b, h, w, "cuda") + 8 * torch.randn(
            b, 2, h, w, device="cuda", generator=g)
        coords[:, 0, :3] = -20.0               # rows of far-out-of-range taps
        coords[:, 1, -3:] = h + 15.5
        yield (f"{b}x{h}x{w}" + ("" if levels == 4 else f", {levels} level"),
               build_corr_pyramid(f1, f2)[:levels], coords.contiguous())


def band_cases(torch):
    """(label, tensor, hv, wv) at each of BAND_SHAPES, seeded; the tensor is
    random, so the band is not zero before the call."""
    g = torch.Generator(device="cuda").manual_seed(8)
    for label, shape, hv, wv in BAND_SHAPES:
        yield label, torch.randn(*shape, device="cuda", generator=g), hv, wv


def check_corr_lookup(torch, shape, pyr, coords):
    """The corr-lookup kernel vs plain (limit 1e-5) on one of
    :func:`lookup_cases`; returns the error, the times and the bound at
    that shape, and the sectors it touches."""
    from cvpr2021_vspw_implement_tpu_torch.ops.corr_lookup import (
        lookup_corr_pyramid, lookup_corr_pyramid_flops,
        lookup_corr_pyramid_plain)

    b, _, h, w = coords.shape
    levels = len(pyr)
    got = lookup_corr_pyramid(pyr, coords)
    torch.cuda.synchronize()
    want = lookup_corr_pyramid_plain(pyr, coords)
    lib = grid_sample_lookup(pyr, coords)
    err = (got - want).abs().max().item()
    print(f"corr_lookup at {shape}: max |kernel - plain| = {err:.3e} (limit "
          f"1e-5); |grid_sample - plain| = "
          f"{(lib - want).abs().max().item():.3e}")
    if not err <= 1e-5:
        raise SystemExit(f"corr_lookup kernel disagrees with its plain "
                         f"version at {shape}")
    row = {"shape": shape, "max_abs_err": err,
           **three_clocks(lambda: lookup_corr_pyramid(pyr, coords),
                          lambda: lookup_corr_pyramid_plain(pyr, coords),
                          {"library": lambda: grid_sample_lookup(pyr, coords)},
                          lookup_corr_pyramid)}
    t_bytes = lookup_bytes(pyr, coords) / HBM_BYTES_PER_S
    t_ops = lookup_corr_pyramid_flops(b, h, w, levels) / F32_FLOP_PER_S
    row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    # the same bytes with the pyramid read in whole 32-byte sectors (on the
    # extra JSON line: computed, not measured)
    sectors = lookup_sectors(pyr, coords)
    row["floor"] = {"sectors": sectors, "sector_floor_ms": 1e3 * (
        32 * sectors + 4 * (coords.numel() + got.numel())) / HBM_BYTES_PER_S}
    print(f"corr_lookup at {shape}: {clocks_text(row)}; bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}), sector floor "
          f"{row['floor']['sector_floor_ms']:.5f} ms ({sectors} 32-byte "
          "sectors of the pyramid read, the coords and the output)")
    return row


def three_clocks(kernel, plain, yardsticks, wrapper):
    """The clocks of a kernel whose device time may be shorter than its
    host enqueue (B1, B6, nearest's backward): ``ms``, ``plain_ms`` and
    ``<name>_ms`` of each yardstick (``library`` first) are device times a
    call, from a CUDA graph
    of the calls replayed between events (kernels/timing.py::device_ms);
    ``profiler_ms`` and ``<name>_profiler_ms`` the profiler's device time a
    call; ``enqueue_ms`` and ``<name>_enqueue_ms`` the host's time a call.
    The wrapper's launch counter is left as it was."""
    from cvpr2021_vspw_implement_tpu_torch.kernels import timing

    out = {"ms": timing.device_ms(kernel, counted=(wrapper,)),
           "plain_ms": timing.device_ms(plain, n=10),
           "profiler_ms": timing.profiler_ms(kernel, counted=(wrapper,)),
           "enqueue_ms": timing.enqueue_ms(kernel, counted=(wrapper,))}
    for name, fn in yardsticks.items():
        out[f"{name}_ms"] = timing.device_ms(fn, n=20)
        out[f"{name}_profiler_ms"] = timing.profiler_ms(fn)
        out[f"{name}_enqueue_ms"] = timing.enqueue_ms(fn)
    return out


def clocks_text(row):
    """The clocks of :func:`three_clocks` as one line of text."""
    def ms(v):
        return "not measured" if v is None else f"{v:.5f}"

    parts = [f"device {ms(row['ms'])} ms a launch (graph replay), profiler "
             f"{ms(row['profiler_ms'])}, host enqueue "
             f"{ms(row['enqueue_ms'])}; plain {ms(row['plain_ms'])} "
             "(device)"]
    for key in row:
        if key.endswith("_enqueue_ms"):
            name = key[:-len("_enqueue_ms")]
            parts.append(f"{name} device {ms(row[name + '_ms'])}, profiler "
                         f"{ms(row[name + '_profiler_ms'])}, enqueue "
                         f"{ms(row[key])}")
    return "; ".join(parts)


def smi_clocks():
    """The card's SM clock, its maximum, power draw and temperature, as
    nvidia-smi reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[0]


def check_kernels(torch):
    """Each kernel vs plain at the shapes the paths give it; returns the
    kernels' JSON rows (launches filled in later)."""
    at_tc, at_train, one_level = (check_corr_lookup(torch, *case)
                                  for case in lookup_cases(torch))
    one_level["launches"] = 0
    g = torch.Generator(device="cuda").manual_seed(0)
    k1 = {
        "name": "corr_lookup", "route": "cuda",
        "source": "cvpr2021_vspw_implement_tpu_torch/kernels/csrc/"
                  "corr_lookup.cu",
        "replaces": "cvpr2021_vspw_implement_tpu/ops/pallas/corr.py:234",
        **at_tc, "also_at": [at_train, one_level],
    }

    # both shapes TC gives the GRU pass: 60x107 exact, 60x112 bucketed
    k2 = {
        "name": "sep_gru", "route": "cuda",
        "source": "cvpr2021_vspw_implement_tpu_torch/kernels/csrc/sep_gru.cu",
        "replaces": "cvpr2021_vspw_implement_tpu/ops/pallas/gru.py:178",
        **check_sep_gru(torch, g, 60, 107),
        "also_at": [check_sep_gru(torch, g, 60, 112)],
    }
    rows = [k1, k2, *check_update_kernels(torch, g), *check_local_agg(torch),
            check_band_zero(torch)]
    for k in [*rows, {"name": "corr_lookup", **at_train},
              {"name": "corr_lookup", **one_level},
              {"name": "sep_gru", **k2["also_at"][0]},
              *[{"name": r["name"], **a} for r in rows
                if r["name"].startswith("local_") for a in r["also_at"]]]:
        simt = (f", f32 CUDA-core bound {k['bound_f32_simt_ms']:.4f} ms"
                if "bound_f32_simt_ms" in k else "")
        crop = (f", the kernel on the contiguous crop {k['crop_ms']:.4f} ms"
                if "crop_ms" in k else "")
        print(f"{k['name']} at {k['shape']}: kernel {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.4f} ms, library {k['library_ms']:.4f} ms, "
              f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}){simt}{crop}")
    return rows


def tensor_core_bound(row, flops, nbytes):
    """The bounds of a kernel of f32 products on the tensor cores (B2-B5):
    ``bound_ms`` at the f32-accurate tensor-core rate (3xTF32, 165
    TFLOP/s), and ``bound_f32_simt_ms`` at the CUDA cores' f32 rate, either
    against the bytes.  The second is printed and goes to the extra JSON
    line, not to the kernels line."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / TF32X3_FLOP_PER_S
    row["bound_ms"] = 1e3 * max(t_ops, t_bytes)
    row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    row["bound_f32_simt_ms"] = 1e3 * max(flops / F32_FLOP_PER_S, t_bytes)


def check_sep_gru(torch, g, h, w):
    """The GRU-pass kernel vs plain at 1 x h x w (hd 128, cx 256), both
    axes (limit 1e-4); returns its numbers per pass, the mean of the axes."""
    from cvpr2021_vspw_implement_tpu_torch.ops.sep_gru import (
        sep_conv_gru_pass, sep_conv_gru_pass_flops, sep_conv_gru_pass_plain)

    p = h * w
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
    err = max(errs)
    print(f"sep_gru at 1x{h}x{w}: max |kernel - plain| = {err:.3e} over both "
          "axes (limit 1e-4)")
    if not err <= 1e-4:
        raise SystemExit(f"sep_gru kernel disagrees with its plain version "
                         f"at 1x{h}x{w}")
    row = {"shape": f"1x{h}x{w}", "max_abs_err": err,
           # per pass, the mean of the two axes
           **{k: t / 2 for k, t in times.items()}}
    tensor_core_bound(
        row, sep_conv_gru_pass_flops(1, h, w, hd, cx),
        4 * (p * (hd + cx + hd) + 5 * (hd + cx) * 3 * hd + 3 * hd))
    return row


def ptxas_lines(log):
    """``ptxas -v`` lines of the kernels in an nvcc log: each kernel's
    mangled name (which carries its tap shape and epilogue, or its mode),
    registers, spills and static shared memory."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and any(k in name for k in (
                "tap_mma_kernel", "local_agg_kernel", "corr_lookup_kernel",
                "band_zero_kernel", "query_kernel", "key_kernel",
                "nearest_kernel")) and (
                "registers" in line or "spill" in line):
            out.append(f"{name}: {line.strip()}")
    return out


def check_update_kernels(torch, g):
    """The fused update-block kernels vs plain at the training shape (crop
    479 pads to 480: 60x60 features, batch 2); returns their JSON rows."""
    from cvpr2021_vspw_implement_tpu_torch.ops.gru_flowhead import (
        gru_flowhead, gru_flowhead_flops, gru_flowhead_plain)
    from cvpr2021_vspw_implement_tpu_torch.ops.motion_encoder import (
        motion_encoder, motion_encoder_flops, motion_encoder_plain)

    b, h, w, ck, hd, cx, cf = 2, 60, 60, 324, 128, 256, 256
    p = h * w

    def weights(shapes):
        return {name: (0.03 * torch.randn(*s, device="cuda", generator=g),
                       0.1 * torch.randn(s[2], device="cuda", generator=g))
                for name, s in shapes.items()}

    def timed(row, fn, plain, args):
        row["plain_ms"] = cuda_ms(lambda: plain(*args))
        row["ms"] = cuda_ms(lambda: fn(*args))
        # the yardstick: the same F.conv2d composition with PyTorch's
        # default cuDNN settings (TF32 allowed)
        torch.backends.cudnn.allow_tf32 = True
        row["library_ms"] = cuda_ms(lambda: plain(*args))
        torch.backends.cudnn.allow_tf32 = False

    def n_weights(ws):
        return sum(wt.numel() + bias.numel() for wt, bias in ws.values())

    csrc = "cvpr2021_vspw_implement_tpu_torch/kernels/csrc/"
    pallas = "cvpr2021_vspw_implement_tpu/ops/pallas/raft_update.py"

    corr = torch.randn(b, ck, h, w, device="cuda", generator=g)
    flow = 2 * torch.randn(b, 2, h, w, device="cuda", generator=g)
    mw = weights({"convc1": (1, ck, 256), "convc2": (9, 256, 192),
                  "convf1": (49, 2, 128), "convf2": (9, 128, 64),
                  "conv": (9, 256, 126)})
    got = motion_encoder(corr, flow, mw)
    torch.cuda.synchronize()
    err = (got - motion_encoder_plain(corr, flow, mw)).abs().max().item()
    print(f"motion_encoder: max |kernel - plain| = {err:.3e} at batch {b} "
          "(limit 1e-4)")
    if not err <= 1e-4:
        raise SystemExit("motion_encoder kernel disagrees with its plain "
                         "version")
    k3 = {"name": "motion_encoder", "route": "cuda",
          "source": csrc + "motion_encoder.cu", "replaces": pallas + ":375",
          "shape": f"{b}x{h}x{w}", "max_abs_err": err}
    timed(k3, motion_encoder, motion_encoder_plain, (corr, flow, mw))
    tensor_core_bound(k3, motion_encoder_flops(b, h, w, ck),
                      4 * (b * p * (ck + 2 + 128) + n_weights(mw)))

    net = torch.tanh(torch.randn(b, hd, h, w, device="cuda", generator=g))
    x = torch.randn(b, cx, h, w, device="cuda", generator=g)
    cin = hd + cx
    gw = weights({"zr1": (5, cin, 2 * hd), "q1": (5, cin, hd),
                  "zr2": (5, cin, 2 * hd), "q2": (5, cin, hd),
                  "fh_conv1": (9, hd, cf), "fh_conv2": (9, cf, 2)})
    got_net, got_delta = gru_flowhead(net, x, gw)
    torch.cuda.synchronize()
    want_net, want_delta = gru_flowhead_plain(net, x, gw)
    err = max((got_net - want_net).abs().max().item(),
              (got_delta - want_delta).abs().max().item())
    print(f"gru_flowhead: max |kernel - plain| = {err:.3e} over net and "
          f"delta at batch {b} (limit 1e-4)")
    if not err <= 1e-4:
        raise SystemExit("gru_flowhead kernel disagrees with its plain "
                         "version")
    k4 = {"name": "gru_flowhead", "route": "cuda",
          "source": csrc + "gru_flowhead.cu", "replaces": pallas + ":396",
          "shape": f"{b}x{h}x{w}", "max_abs_err": err}
    timed(k4, gru_flowhead, gru_flowhead_plain, (net, x, gw))
    tensor_core_bound(k4, gru_flowhead_flops(b, h, w, hd, cx, cf),
                      4 * (b * p * (hd + cx + hd + 2) + n_weights(gw)))
    return [k3, k4]


def update_block_routes(torch):
    """One refinement of RAFT's update block by each of its two routes, on
    CUDA events with TF32 off (as the CLIs run): fused, the motion encoder
    (B2) then the GRU + flow head (B3); unfused, cuDNN's encoder, the two
    GRU passes (B4) and cuDNN's flow head.  At the ETC train shape (2x60x60,
    under the model's 4096-position gate: fused) and the TC shape (1x60x107,
    above it: unfused).  The routes compute one function: their outputs
    agree within 1e-4 of the largest.  Returns {shape: {route: ms}}."""
    from cvpr2021_vspw_implement_tpu_torch.models.raft.update import \
        BasicUpdateBlock
    from cvpr2021_vspw_implement_tpu_torch.ops.gru_flowhead import \
        gru_flowhead
    from cvpr2021_vspw_implement_tpu_torch.ops.motion_encoder import \
        motion_encoder

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(9)
        ub = BasicUpdateBlock(128).cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    with torch.inference_mode():
        taps = ub.taps()
        for b, h, w in ((2, 60, 60), (1, 60, 107)):
            def rand(c):
                return torch.randn(b, c, h, w, device="cuda", generator=g)

            corr, flow = rand(324), 2 * rand(2)
            net, inp = torch.tanh(rand(128)), torch.relu(rand(128))

            def fused():
                motion = motion_encoder(corr, flow, taps["encoder"])
                return gru_flowhead(net, torch.cat([inp, motion], 1),
                                    taps["gru"])

            def unfused():
                motion = ub.encoder(flow, corr)
                h2 = ub.gru(net, torch.cat([inp, motion], 1), taps["gru"])
                return h2, ub.flow_head(h2)

            (n1, d1), (n2, d2) = fused(), unfused()
            err = max((n1 - n2).abs().max().item(),
                      (d1 - d2).abs().max().item())
            scale = max(n2.abs().max().item(), d2.abs().max().item())
            shape = f"{b}x{h}x{w}"
            out[shape] = {"fused_b2_b3_ms": cuda_ms(fused),
                          "cudnn_b4_cudnn_ms": cuda_ms(unfused),
                          "max_abs_diff": err}
            print(f"update block at {shape}, one refinement: fused B2 + B3 "
                  f"{out[shape]['fused_b2_b3_ms']:.4f} ms, cuDNN encoder + "
                  f"B4 + cuDNN flow head "
                  f"{out[shape]['cudnn_b4_cudnn_ms']:.4f} ms; outputs "
                  f"differ by {err:.3e} (limit 1e-4 of {scale:.3e})")
            if not err <= 1e-4 * scale:
                raise SystemExit(f"the update-block routes disagree at "
                                 f"{shape}")
    return out


def unfold_local_agg(x, yd, yv, r, mode, temp=3.0):
    """The reference's formulation of one warp aggregation
    (models/warp_our.py:20-50 and 131-160, as tests/test_warp_our.py:21-40
    replays it): ``F.unfold`` of the padded context over every window
    offset, distances by ``matmul``, then the weighted sum, or the gather at
    the argmax, over the unfolded values.  Timed as the PyTorch yardstick of
    the local-aggregation kernels; the port never calls it."""
    import torch
    import torch.nn.functional as F
    n, c, h, w = x.shape
    kk = (2 * r + 1) ** 2
    x2 = x.square().sum(1).view(n, h * w, 1)
    y2 = yd.square().sum(1, keepdim=True)
    oy = F.unfold(F.pad(yd, (r, r, r, r)), kernel_size=(h, w)).view(
        n, c, h * w, kk).permute(0, 2, 1, 3)               # [n, hw, c, kk]
    oy2 = F.unfold(F.pad(y2, (r, r, r, r), value=1e20),
                   kernel_size=(h, w)).view(n, h * w, kk)
    xq = x.view(n, c, h * w).permute(0, 2, 1).unsqueeze(2)  # [n, hw, 1, c]
    dist = x2 + oy2 - 2.0 * torch.matmul(xq, oy).view(n, h * w, kk)
    cv = yv.shape[1]
    ov = F.unfold(F.pad(yv, (r, r, r, r)), kernel_size=(h, w)).view(
        n, cv, h * w, kk)
    if mode == "nearest":
        idx = dist.argmax(-1)[:, None, :, None].expand(n, cv, h * w, 1)
        return torch.gather(ov, 3, idx).view(n, cv, h, w)
    if mode == "softmax":
        wts = torch.softmax(1.0 / (dist * temp + 1e-5), -1)
    else:
        wts = 1.0 - (torch.sigmoid(dist) - 0.5) * 2.0
    out = torch.matmul(ov.permute(0, 2, 1, 3), wts.unsqueeze(-1))
    return out.view(n, h * w, cv).permute(0, 2, 1).reshape(n, cv, h, w) / kk


def weight_spread(torch, dist, mode, temp=3.0):
    """Quantiles 0.1, 0.5 and 0.9 over positions of the largest window
    weight over the window's mean weight (1 where the weights are uniform);
    dist [B, k, k, H, W]."""
    dist = dist.flatten(1, 2)
    if mode == "softmax":
        wts = torch.softmax(1.0 / (dist * temp + 1e-5), 1)
    else:
        wts = 1.0 - (torch.sigmoid(dist) - 0.5) * 2.0
    ratio = (wts.max(1).values / wts.mean(1)).flatten()
    return torch.quantile(ratio, torch.tensor([0.1, 0.5, 0.9],
                                              device=ratio.device)).tolist()


def near_ties(dist):
    """[B, H, W] mask of the positions whose two largest window distances
    are in the image and lie within 1e-4 relative, where rounding may flip
    the argmax; dist [B, k, k, H, W]."""
    top = dist.flatten(1, 2).topk(2, dim=1).values
    return (top[:, 0] < 1e19) & (top[:, 0] - top[:, 1]
                                 <= 1e-4 * top[:, 0].abs())


def local_agg_case(torch, g, cd, cv, h, w):
    """Near-match inputs of B5 at [1, ., h, w]: y_dist is the N(0, 0.05^2) x
    shifted by one pixel down and one left, plus noise whose squared norm at
    each pixel lies in [0.01, 0.1], so the match's softmax score is 3.3 to
    33 against about 0.5 elsewhere, far from the pole of 1 / (dist * 3 +
    1e-5); y_val N(0, 1).  On a bucketed grid the band holds the same
    noise, which the kernel must ignore."""
    x = 0.05 * torch.randn(1, cd, h, w, device="cuda", generator=g)
    sq = 10.0 ** (torch.rand(1, 1, h, w, device="cuda", generator=g) - 2.0)
    yd = torch.roll(x, (1, -1), (2, 3)) + (sq / cd).sqrt() * torch.randn(
        1, cd, h, w, device="cuda", generator=g)
    yv = torch.randn(1, cv, h, w, device="cuda", generator=g)
    return x, yd, yv


#: the shapes the paths give B5, (label, Cd, Cv, h, w, valid size, modes):
#: our_warp at 480x853 (1x60x107, 128-d distances, 256-d values, r = 10)
#: and in the 480x896 bucket (60x112, valid 60x107); our_warp_merge's
#: 256-d C4 embeddings, exact and bucketed (the smoke runs it sigmoid)
LOCAL_AGG_CASES = (
    ("1x60x107, Cd 128, Cv 256, r 10", 128, 256, 60, 107, None,
     ("sigmoid", "softmax", "nearest")),
    ("1x60x112 valid 60x107, Cd 128, Cv 256, r 10", 128, 256, 60, 112,
     (60, 107), ("sigmoid", "softmax", "nearest")),
    ("merge 1x60x107, Cd 256, Cv 256, r 10", 256, 256, 60, 107, None,
     ("sigmoid",)),
    ("merge 1x60x112 valid 60x107, Cd 256, Cv 256, r 10", 256, 256, 60, 112,
     (60, 107), ("sigmoid",)))


def check_local_agg_at(torch, mode, label, x, yd, yv, valid, r=10,
                       temp=3.0):
    """One B5 mode vs its plain version on one of LOCAL_AGG_CASES.  Sigmoid
    and softmax: max abs error at most 1e-4 and at most 1e-4 of the largest
    output.  Nearest: the positions whose two largest in-image window
    distances lie within 1e-4 relative are excused (rounding may flip the
    argmax there); every other position must be equal.  With a valid size
    also: the band all zero, and the valid region against the launch on
    the contiguous crop (the difference printed, and whether it is
    bitwise).  Returns the case's row: errors, times (CUDA events), bound
    and the unfold yardstick (on the crop)."""
    from cvpr2021_vspw_implement_tpu_torch.ops import local_agg
    from cvpr2021_vspw_implement_tpu_torch.ops.local_pairwise import \
        local_pairwise_dist

    b, cd, h, w = x.shape
    cv = yv.shape[1]
    hv, wv = valid or (h, w)
    p, kk = hv * wv, (2 * r + 1) ** 2
    fn = getattr(local_agg, f"local_{mode}_aggregate")
    plain = getattr(local_agg, f"local_{mode}_aggregate_plain")
    kw = {"temp": temp} if mode == "softmax" else {}
    vkw = dict(kw, valid_hw=valid) if valid else kw
    crop = [t[..., :hv, :wv].contiguous() for t in (x, yd, yv)]
    got = fn(x, yd, yv, r, **vkw)
    torch.cuda.synchronize()
    want = plain(x, yd, yv, r, **vkw)
    dist = local_pairwise_dist(x, yd, r, valid)
    lib_err = (unfold_local_agg(*crop, r, mode, temp)
               - want[..., :hv, :wv]).abs().max().item()
    err = (got - want).abs().max().item()
    row = {"shape": label, "max_abs_err": err}
    if mode == "nearest":
        tie = near_ties(dist)
        bad = int(((got != want).any(1) & ~tie).sum().item())
        row["excused_near_ties"] = int(tie.sum().item())
        row["mismatches"] = bad
        picks_in = int((dist.flatten(1, 2).max(1).values[..., :hv, :wv]
                        < 1e19).sum().item())
        text = (f"{bad} mismatching positions of {p} after excusing "
                f"{row['excused_near_ties']} near-ties (max abs error "
                f"{err:.3e}, out-of-image picks {p - picks_in})")
        ok = bad == 0
        nbytes = 4 * (b * p * 2 * cd + picks_in * cv + b * cv * h * w)
    else:
        q = weight_spread(torch, dist[..., :hv, :wv], mode, temp)
        scale = want.abs().max().item()
        row["rel_err"] = err / scale
        row["weight_spread_q10_q50_q90"] = q
        text = (f"max |kernel - plain| = {err:.3e} = {row['rel_err']:.3e} "
                f"of max |plain| {scale:.3e} (limits 1e-4 and 1e-4 of max "
                f"|plain|); largest over mean window weight, quantiles "
                f"0.1/0.5/0.9 over positions: {q[0]:.4g}/{q[1]:.4g}/"
                f"{q[2]:.4g} (1 if uniform, {kk} at most)")
        ok = err <= 1e-4 and err <= 1e-4 * scale
        nbytes = 4 * (b * p * (2 * cd + cv) + b * cv * h * w)
    if valid:
        exact = fn(*crop, r, **kw)
        gap = (got[..., :hv, :wv] - exact).abs().max().item()
        bitwise = torch.equal(got[..., :hv, :wv], exact)
        band = int(torch.count_nonzero(got[..., hv:, :]).item()
                   + torch.count_nonzero(got[..., :hv, wv:]).item())
        row.update(crop_gap=gap, crop_bitwise=bitwise, band_nonzero=band)
        text += (f"; valid region vs the launch on the {hv}x{wv} crop: max "
                 f"|diff| {gap:.3e}, {'bitwise' if bitwise else 'NOT bitwise'}"
                 f"; band nonzero elements {band}")
        if mode == "nearest":
            crop_ok = not ((got[..., :hv, :wv] != exact).any(1)
                           & ~tie[..., :hv, :wv]).any().item()
        else:
            crop_ok = gap <= 1e-4 and gap <= 1e-4 * exact.abs().max().item()
        ok = ok and band == 0 and (bitwise or crop_ok)
        row["crop_ms"] = cuda_ms(lambda: fn(*crop, r, **kw))
    print(f"local_{mode}_aggregate at {label}: {text}; |unfold - plain| = "
          f"{lib_err:.3e}")
    if not ok:
        raise SystemExit(f"local_{mode}_aggregate kernel disagrees with its "
                         f"plain version at {label}")
    row["plain_ms"] = cuda_ms(lambda: plain(x, yd, yv, r, **vkw), n=5)
    row["ms"] = cuda_ms(lambda: fn(x, yd, yv, r, **vkw))
    row["library_ms"] = cuda_ms(
        lambda: unfold_local_agg(*crop, r, mode, temp), n=5)
    # the work of the valid region, and the whole output written
    tensor_core_bound(row, local_agg.local_aggregate_flops(
        mode, b, hv, wv, cd, cv, r), nbytes)
    return row


def check_local_agg(torch):
    """The three local-aggregation kernels vs plain at every shape of
    LOCAL_AGG_CASES (temp 3); returns their JSON rows, each at our_warp's
    exact shape with the other shapes under ``also_at``."""
    g = torch.Generator(device="cuda").manual_seed(5)
    by_mode = {}
    for label, cd, cv, h, w, valid, modes in LOCAL_AGG_CASES:
        x, yd, yv = local_agg_case(torch, g, cd, cv, h, w)
        for mode in modes:
            by_mode.setdefault(mode, []).append(
                check_local_agg_at(torch, mode, label, x, yd, yv, valid))
    return [{"name": f"local_{mode}_aggregate", "route": "cuda",
             "source": "cvpr2021_vspw_implement_tpu_torch/kernels/csrc/"
                       "local_agg.cu",
             "replaces": "cvpr2021_vspw_implement_tpu/ops/pallas/"
                         "local_agg.py:" + {"sigmoid": "229",
                                            "softmax": "121",
                                            "nearest": "197"}[mode],
             **rows[0], "also_at": rows[1:]}
            for mode, rows in by_mode.items()]


def unfold_local_agg_backward(x, yd, yv, g, r, mode, temp=3.0):
    """``.backward()`` through :func:`unfold_local_agg` (its forward
    included, as the kernels recompute the distances): the PyTorch
    yardstick of B5's backward; timed with TF32 allowed, never called by
    the port."""
    ts = [t.detach().requires_grad_() for t in (x, yd, yv)]
    unfold_local_agg(*ts, r, mode, temp).backward(g)
    return [t.grad for t in ts]


#: the training shapes of B5's backward: (label, Cd, modes); B = 2, the 479
#: crop's 60x60 features, Cv 256, r = 10
LOCAL_AGG_BACKWARD_CASES = (
    ("2x60x60, Cd 128, Cv 256, r 10", 128, ("sigmoid", "softmax", "nearest")),
    ("merge 2x60x60, Cd 256, Cv 256, r 10", 256, ("sigmoid",)))


#: how local_agg_bwd.cu computes each smooth mode's window products
BACKWARD_ROUTES = {
    "sigmoid": "tensor cores, 3xTF32 mma.sync m16n8k8, every window product "
               "(D, A, dx; dy_dist, dy_val)",
    "softmax": "tensor cores, 3xTF32 mma.sync m16n8k8 (A, dx; dy_dist, "
               "dy_val); the distances D on the CUDA cores in f32"}


#: the seed of the generator that makes LOCAL_AGG_BACKWARD_CASES' inputs
BACKWARD_SEED = 8


def local_agg_backward_case(torch, g, cd, cv=256, h=60, w=60):
    """B5's backward inputs at ``cd`` (``g`` a CUDA generator): the
    near-match x, y_dist, y_val of :func:`local_agg_case` and the same
    moved by 7 columns as the second image, and an upstream gradient
    N(0, 1) [2, cv, h, w]."""
    x, yd, yv = local_agg_case(torch, g, cd, cv, h, w)
    x, yd, yv = (torch.cat([t, t.roll(7, 3)]) for t in (x, yd, yv))
    return x, yd, yv, torch.randn(2, cv, h, w, device="cuda", generator=g)


def nearest_index_check(torch, x, yd, yv, r):
    """The nearest forward with its index buffer (the training path's
    launch) against the eval launch and the plain argmax: its output
    bitwise the eval kernel's and bitwise the plain gather at its index;
    its index equal to the plain argmax off the near-ties (excused as in
    :func:`check_local_agg_at`).  Returns (the kernel's int32 index, the
    index the plain backward gathers through: the plain argmax, and the
    kernel's pick at an excused near-tie where the two differ)."""
    from cvpr2021_vspw_implement_tpu_torch.ops import local_agg
    from cvpr2021_vspw_implement_tpu_torch.ops.local_pairwise import \
        local_pairwise_dist

    out, idx = local_agg.local_nearest_aggregate_index(x, yd, yv, r)
    eval_out = local_agg.local_nearest_aggregate(x, yd, yv, r)
    picked = local_agg.local_nearest_aggregate_plain(x, yd, yv, r,
                                                     idx=idx.long())
    torch.cuda.synchronize()
    plain_idx = local_agg.local_nearest_index_plain(x, yd, r)
    tie = near_ties(local_pairwise_dist(x, yd, r))
    differ = idx.long() != plain_idx
    off_tie = int((differ & ~tie).sum().item())
    as_eval, as_picked = torch.equal(out, eval_out), torch.equal(out, picked)
    print(f"local_nearest_aggregate with its index buffer at "
          f"{'x'.join(map(str, idx.shape))}: output bitwise the eval "
          f"launch's {as_eval}, bitwise the plain gather at its index "
          f"{as_picked}; index vs the plain argmax: "
          f"{int(differ.sum().item())} positions differ, "
          f"{int(tie.sum().item())} near-ties excused, {off_tie} differ "
          "off them (limit 0)")
    if not (as_eval and as_picked and off_tie == 0):
        raise SystemExit("the nearest forward's index buffer disagrees with "
                         "its output or with the plain argmax")
    return idx, torch.where(differ & tie, idx.long(), plain_idx)


def crowded_y_dist(torch, yd, r):
    """``yd`` scaled by 100 at the keys whose row and column are both r mod
    2r + 1: every window that lies inside the image holds exactly one of
    them, and the nearest mode's argmax picks it, so one key takes (2r +
    1)^2 picks an image (a key with an outlier norm in trained
    embeddings)."""
    k = 2 * r + 1
    h, w = yd.shape[-2:]
    on = ((torch.arange(h, device=yd.device) % k == r)[:, None]
          & (torch.arange(w, device=yd.device) % k == r))
    return torch.where(on, 100.0 * yd, yd)


def nearest_picks(torch, idx, r):
    """[B, H * W]: how many queries of each image picked each key inside it,
    from the window offsets ``idx`` [B, H, W] (o = dy * k + dx from (row -
    r, col - r)); a pick outside the image takes nothing."""
    b, h, w = idx.shape
    k = 2 * r + 1
    idx = idx.long()
    rows = torch.arange(h, device=idx.device)[:, None] + idx // k - r
    cols = torch.arange(w, device=idx.device) + idx % k - r
    inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    key = (torch.arange(b, device=idx.device)[:, None, None] * h * w
           + rows * w + cols)[inside]
    return torch.bincount(key, minlength=b * h * w).view(b, h * w)


def nearest_scatter_add(torch, idx, g, r):
    """The one PyTorch call that computes the nearest backward, the
    yardstick of its kernel (never called by the port): ``scatter_add_`` of
    g [B, Cv, H, W] into a zero [B, Cv, (H + 2r)(W + 2r)] buffer at each
    query's padded key index, expanded over Cv.  The index and the buffer
    are made here, outside the call.  Returns (the call, the buffer cropped
    to [B, Cv, H, W])."""
    b, cv, h, w = g.shape
    k, wp = 2 * r + 1, w + 2 * r
    idx = idx.long()
    at = ((torch.arange(h, device=g.device)[:, None] + idx // k) * wp
          + torch.arange(w, device=g.device) + idx % k)
    at = at.view(b, 1, h * w).expand(b, cv, h * w)
    buf = g.new_zeros(b, cv, (h + 2 * r) * wp)
    src = g.view(b, cv, h * w)
    return (lambda: buf.scatter_add_(2, at, src),
            buf.view(b, cv, h + 2 * r, wp)[..., r:r + h, r:r + w])


def check_nearest_backward(torch, label, x, yd, yv, up, r):
    """The nearest backward kernel, gathering through the forward kernel's
    index (held by :func:`nearest_index_check`), against the plain backward
    through the plain argmax: equal (the same additions in the same order).
    ``scatter_add_`` (:func:`nearest_scatter_add`) within 1e-5 of the
    largest element (its atomics add in another order).  The kernel and
    ``scatter_add_`` timed by graph replay, the profiler and the host, the
    plain backward by graph replay (:func:`three_clocks`).  Bound: the
    bytes this index needs, the index read once, dy_val written once and g
    read at the picks inside the image (all of g read: ``bound_all_g_ms``).
    Returns the row."""
    from cvpr2021_vspw_implement_tpu_torch.ops import local_agg

    fn = local_agg.local_nearest_aggregate_backward
    plain_fn = local_agg.local_nearest_aggregate_backward_plain
    idx, plain_idx = nearest_index_check(torch, x, yd, yv, r)
    b, cv, h, w = up.shape
    got = fn(idx, up, r)
    want = plain_fn(plain_idx, up, r)
    library, crop = nearest_scatter_add(torch, idx, up, r)
    library()
    inside = int(nearest_picks(torch, idx, r).sum().item())
    torch.cuda.synchronize()
    equal = torch.equal(got, want)
    scale = want.abs().max().item()
    lib_err = (crop - want).abs().max().item() / scale
    print(f"local_nearest_aggregate_backward at {label}: kernel equal to the "
          f"plain backward {equal} (limit equal); scatter_add_ max |library "
          f"- plain| / max |plain| {lib_err:.3e} (limit 1e-5)")
    if not equal or not lib_err <= 1e-5:
        raise SystemExit("local_nearest_aggregate_backward kernel or its "
                         f"scatter_add_ yardstick disagrees at {label}")
    row = {"shape": label, "max_abs_err": (got - want).abs().max().item(),
           **three_clocks(lambda: fn(idx, up, r),
                          lambda: plain_fn(plain_idx, up, r),
                          {"library": library}, fn),
           "bound_ms": 1e3 * 4 * (b * h * w + b * cv * h * w + inside * cv)
           / HBM_BYTES_PER_S, "bound_by": "bytes",
           "bound_all_g_ms": 1e3 * 4 * (b * h * w + 2 * b * cv * h * w)
           / HBM_BYTES_PER_S}
    print(f"local_nearest_aggregate_backward at {label}: {clocks_text(row)} "
          f"(library: scatter_add_); bound {row['bound_ms']:.5f} ms (bytes, "
          f"g read at the {inside} picks inside the image; all of g "
          f"{row['bound_all_g_ms']:.5f})")
    return row


def check_local_agg_backward(torch):
    """B5's backward kernels (local_agg_bwd.cu) against their plain
    backward at the training shapes, on near-match inputs and an upstream
    gradient N(0, 1): each of dx, dy_dist and dy_val within 1e-4 of the
    largest element of a float64 run of the plain backward (the f32 plain
    backward's own distance from it is printed beside: softmax's G carries
    s^2 times the rounding of near-match distances); nearest by
    :func:`check_nearest_backward`, on these inputs and on the crowded
    ones of :func:`crowded_y_dist`.
    Times (CUDA events) the kernel, the plain backward and the unfold
    yardstick's forward and backward (TF32 allowed), and the query-side and
    key-side kernels apart (the profiler's device time); the bound counts
    the window products at the 3xTF32 rate.  Returns the kernels' rows,
    our_warp's shape first."""
    from cvpr2021_vspw_implement_tpu_torch.kernels import timing
    from cvpr2021_vspw_implement_tpu_torch.ops import local_agg

    g = torch.Generator(device="cuda").manual_seed(BACKWARD_SEED)
    b, h, w, cv, r = 2, 60, 60, 256, 10
    rows = {}
    for label, cd, modes in LOCAL_AGG_BACKWARD_CASES:
        x, yd, yv, up = local_agg_backward_case(torch, g, cd)
        for mode in modes:
            if mode == "nearest":
                rows[mode] = [
                    check_nearest_backward(torch, label, x, yd, yv, up, r),
                    check_nearest_backward(torch, f"crowded {label}", x,
                                           crowded_y_dist(torch, yd, r), yv,
                                           up, r)]
                continue
            name = f"local_{mode}_aggregate_backward"
            fn = getattr(local_agg, name)
            plain_fn = getattr(local_agg, f"{name}_plain")
            flops = local_agg.local_aggregate_backward_flops(
                mode, b, h, w, cd, cv, r)
            args = (x, yd, yv, up, r)
            got = fn(*args)
            f32 = plain_fn(*args)
            want = plain_fn(*(t.double() for t in args[:4]), r)
            nbytes = 4 * b * h * w * (4 * cd + 3 * cv)
            torch.cuda.synchronize()
            errs = [((a - e).abs().max() / e.abs().max()).item()
                    for a, e in zip(got, want)]
            err = max((a - e).abs().max().item() for a, e in zip(got, want))
            own = str(["%.3e" % ((a - e).abs().max() / e.abs().max()).item()
                       for a, e in zip(f32, want)])
            print(f"{name} at {label}: max |kernel - plain| / max |plain| "
                  f"per gradient (dx, dy_dist, dy_val; plain in float64) "
                  f"{['%.3e' % e for e in errs]} (limit 1e-4); the f32 plain "
                  f"backward's own: {own}")
            if max(errs) > 1e-4:
                raise SystemExit(f"{name} kernel disagrees with its plain "
                                 f"backward at {label}")
            row = {"shape": label, "max_abs_err": err, "rel_err": max(errs)}
            row["ms"] = cuda_ms(lambda: fn(*args))
            # the wrapper's one count covers both kernels: time each
            by_kernel = timing.profiler_kernels_ms(lambda: fn(*args),
                                                   counted=(fn,))
            for side in ("query", "key"):
                row[f"{side}_kernel_ms"] = sum(
                    v for k, v in by_kernel.items()
                    if f"{side}_kernel" in k) or None
            print(f"{name} at {label}: query-side kernel "
                  f"{row['query_kernel_ms']} ms, key-side kernel "
                  f"{row['key_kernel_ms']} ms (profiler device time); "
                  f"route: {BACKWARD_ROUTES[mode]}")
            row["plain_ms"] = cuda_ms(lambda: plain_fn(*args), n=3, warm=1)
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                row["library_ms"] = cuda_ms(lambda: unfold_local_agg_backward(
                    x, yd, yv, up, r, mode), n=3, warm=1)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            tensor_core_bound(row, flops, nbytes)
            rows.setdefault(mode, []).append(row)
    return [{"name": f"local_{mode}_aggregate_backward", "route": "cuda",
             "source": "cvpr2021_vspw_implement_tpu_torch/kernels/csrc/"
                       "local_agg_bwd.cu",
             # port-only: the JAX package trains through the XLA
             # formulation; its Pallas B5 has no VJP
             "replaces": "cvpr2021_vspw_implement_tpu/models/warp_our.py:38",
             **rs[0], "also_at": rs[1:]}
            for mode, rs in rows.items()]


def band_sectors(x, hv, wv):
    """The 32-byte sectors of device memory that the band of ``x`` beyond
    (hv, wv) touches: each row's column run [wv, W) of rows [0, hv) and each
    plane's row run [hv * W, H * W), at the tensor's own address."""
    import torch
    h, w = x.shape[-2:]
    planes = x.numel() // (h * w)
    base = x.data_ptr() % 32

    def spans(start, length):
        """Sectors of runs of ``length`` floats at byte offsets ``start``."""
        first = (base + start) // 32
        last = (base + start + 4 * length - 1) // 32
        return int((last - first + 1).sum().item())

    n = 0
    if wv < w and hv > 0:
        rows = torch.arange(planes * h, dtype=torch.int64).view(planes, h)
        n += spans(4 * (rows[:, :hv].flatten() * w + wv), w - wv)
    if hv < h:
        plane0 = torch.arange(planes, dtype=torch.int64) * (h * w)
        n += spans(4 * (plane0 + hv * w), (h - hv) * w)
    return n


def check_band_zero(torch):
    """The band re-zero kernel vs plain, bitwise, at the shapes bucketed eval
    gives it (R101 at 480x853 in the 480x896 bucket: a 256-channel feature
    and C5 at 60x112, valid 60x107; a correlation-pyramid level of the TC
    pair, [6720, 1, 30, 56], valid 30x53), a rows-only case and a no-band
    case (no launch).  Each is timed on three clocks (:func:`three_clocks`)
    beside the plain version, the two-slice ``zero_()`` and the JAX
    formulation ``torch.where`` over the whole tensor; the bound is the
    bytes written over the memory rate, printed beside the 32-byte sectors
    the band touches.  Returns the kernel's JSON row (at C5, the others
    under ``also_at``)."""
    from cvpr2021_vspw_implement_tpu_torch.ops.band_zero import (
        band_zero, band_zero_plain)

    rows = []
    for label, x, hv, wv in band_cases(torch):
        shape = tuple(x.shape)
        h, w = shape[-2:]
        want = band_zero_plain(x.clone(), hv, wv)
        before = band_zero.launches
        got = band_zero(x, hv, wv)
        torch.cuda.synchronize()
        launched = band_zero.launches - before
        equal = torch.equal(got, want)
        print(f"band_zero at {label} {list(shape)}, valid {hv}x{wv}: "
              f"{'bitwise equal' if equal else 'DIFFERS'} to plain, "
              f"{launched} launch")
        if not equal or launched != (0 if (hv, wv) == (h, w) else 1):
            raise SystemExit(f"band_zero kernel disagrees with its plain "
                             f"version at {label}")
        mask = torch.zeros(h, w, dtype=torch.bool, device="cuda")
        mask[:hv, :wv] = True
        band = x.numel() // (h * w) * (h * w - hv * wv)

        def two_slices():
            x[..., hv:, :].zero_()
            x[..., :hv, wv:].zero_()

        row = {"shape": f"{label} {'x'.join(map(str, shape))}, valid "
                        f"{hv}x{wv}",
               "max_abs_err": 0.0,
               **three_clocks(lambda: band_zero(x, hv, wv),
                              lambda: band_zero_plain(x, hv, wv),
                              {"library": lambda: torch.where(mask, x, 0.0),
                               "two_slice_zero": two_slices}, band_zero),
               "bound_ms": 1e3 * 4 * band / HBM_BYTES_PER_S,
               "bound_by": "bytes"}
        # computed from the shape and address, not measured: on the extra
        # JSON line
        sectors = band_sectors(x, hv, wv)
        row["floor"] = {"bytes_written": 4 * band, "sectors": sectors,
                        "sector_floor_ms": 1e3 * 32 * sectors
                        / HBM_BYTES_PER_S}
        above = (", above half the bound" if row["floor"]["sector_floor_ms"]
                 > row["bound_ms"] / 2 else "")
        print(f"band_zero at {label}: {clocks_text(row)} (library: "
              f"torch.where over the tensor); bound {row['bound_ms']:.5f} ms "
              f"({4 * band} bytes written), sector floor "
              f"{row['floor']['sector_floor_ms']:.5f} ms ({sectors} 32-byte "
              f"sectors touched{above})")
        rows.append(row)
    return {"name": "band_zero", "route": "cuda",
            "source": "cvpr2021_vspw_implement_tpu_torch/kernels/csrc/"
                      "band_zero.cu",
            "replaces": "cvpr2021_vspw_implement_tpu/ops/pallas/band_zero.py:63",
            **rows[0], "also_at": rows[1:]}


def bucketed_vs_exact(torch, model, frames, exact_pngs, bucket_pngs):
    """The eval phases' R101 ClipPSP (rebuilt from the same seed) streamed
    over the video once at exact shapes and once in the 480x896 bucket, the
    upsampled logits captured where each engine argmaxes them.  Holds the
    bucketed logits on the valid region within 1e-3 of the largest exact
    logit (cuDNN picks its algorithms per width, so the sums differ in
    order), and allows the CLI phases' bucketed PNGs to differ from the
    exact ones only at pixels whose exact top-2 margin is below that
    tolerance.  Then times ``encode_frame`` on one frame (CUDA events): as
    the exact engine gives it (a permuted HWC view, so cuDNN runs
    channels-last), as contiguous NCHW, and bucketed (contiguous NCHW,
    padded, masked).  Returns the numbers it printed."""
    from cvpr2021_vspw_implement_tpu_torch import serving
    from cvpr2021_vspw_implement_tpu_torch.ops.interpolate import \
        resize_bilinear
    from cvpr2021_vspw_implement_tpu_torch.ops.masked import (
        bucket_hw, pad_to, resize_bilinear_rt)

    h, w = frames[0].shape[:2]
    captured = []

    def exact_up(logits, size):
        return resize_bilinear(logits.float(), size)[0]

    def bucket_up(logits, pad, fv, hw):
        return resize_bilinear_rt(logits.float(), pad, fv, hw)[0, :, :h, :w]

    def capture(fn, up):
        def wrapped(logits, *args):
            captured.append(up(logits, *args))
            return fn(logits, *args)
        return wrapped

    saved = serving.inference_pred, serving.inference_pred_rt
    serving.inference_pred = capture(saved[0], exact_up)
    serving.inference_pred_rt = capture(saved[1], bucket_up)
    try:
        for engine in (serving.ExactShapeEngine(model),
                       serving.ClipPSPBucketEngine(model, bucket=64)):
            list(serving.ClipPSPStreamer(model, [3, 6, 9], len(frames),
                                         (h, w), engine=engine)
                 .run(iter(frames)))
    finally:
        serving.inference_pred, serving.inference_pred_rt = saved
    n = len(frames)
    if len(captured) != 2 * n:
        raise SystemExit(f"captured {len(captured)} logit maps, expected "
                         f"{2 * n}")
    exact, bucketed = captured[:n], captured[n:]
    err = max((b - e).abs().max().item() for e, b in zip(exact, bucketed))
    tol = 1e-3 * max(e.abs().max().item() for e in exact)
    diff = excused = flips = 0
    for i, (e, b) in enumerate(zip(exact, bucketed)):
        top = e.topk(2, dim=0).values
        near = (top[0] - top[1] < tol).cpu().numpy()
        differ = exact_pngs[i] != bucket_pngs[i]
        diff += int(differ.sum())
        excused += int((differ & near).sum())
        flips += int((e.argmax(0) != b.argmax(0)).sum().item())
    print(f"bucketed vs exact ClipPSP eval: logits on the valid region max "
          f"|diff| {err:.3e} (limit {tol:.3e}, 1e-3 of the largest exact "
          f"logit); CLI PNGs differ at {diff} of {n * h * w} pixels, "
          f"{excused} of them with an exact top-2 margin below the limit; "
          f"argmax flips in this pass {flips}")
    if not (err <= tol and diff == excused):
        raise SystemExit("bucketed eval disagrees with exact eval")

    img = torch.from_numpy(frames[0]).cuda().permute(2, 0, 1)[None]
    pad = bucket_hw(h, w)
    with torch.inference_mode():
        layouts = {
            "exact_permuted_ms": cuda_ms(lambda: model.encode_frame(img),
                                         n=5, warm=2),
            "exact_nchw_ms": cuda_ms(
                lambda: model.encode_frame(img.contiguous()), n=5, warm=2),
            "bucketed_ms": cuda_ms(lambda: model.encode_frame(
                pad_to(img, pad), valid_hw=(h, w)), n=5, warm=2),
        }
    print("encode_frame on one frame (R101, CUDA events): exact as the "
          "engine gives it (permuted HWC view) "
          f"{layouts['exact_permuted_ms']:.2f} ms, exact contiguous NCHW "
          f"{layouts['exact_nchw_ms']:.2f} ms, bucketed {pad[0]}x{pad[1]} "
          f"{layouts['bucketed_ms']:.2f} ms")
    return {"logit_err": err, "logit_tol": tol, "pixels_differ": diff,
            "pixels_excused": excused, **layouts}


def band_zero_launches(torch, raft):
    """The band re-zero's launches in bucketed eval, derived from the
    models: (a frame of R101 ClipPSP, a TC pair of ``raft``).  In the trunk
    the input of every spatial conv (ops/masked.py::masked_trunk), the stem
    max pool, C5 in encode_frame and in fuse_target; in RAFT the input of
    every spatial conv of both encoders, each pyramid level, a refinement's
    spatial convs of the motion encoder and flow head with the GRU's 4 (x
    once, h before each pass and at the end), the mask head's spatial conv
    and the low-resolution flow."""
    from cvpr2021_vspw_implement_tpu_torch.models.resnet import build_encoder

    def spatial_convs(module):
        return sum(isinstance(m, torch.nn.Conv2d) and max(m.kernel_size) > 1
                   for m in module.modules())

    ub = raft.update_block
    return (spatial_convs(build_encoder("resnet101dilated")) + 3,
            spatial_convs(raft.fnet) + spatial_convs(raft.cnet)
            + raft.corr_levels
            + raft.iters * (spatial_convs(ub.encoder)
                            + spatial_convs(ub.flow_head) + 4)
            + spatial_convs(ub.mask) + 1)


#: the TC check's limit on the largest |bucketed - exact| RAFT flow of a
#: pair after its first refinement, px: 8.8x the sound run's 1.132e-4 on
#: the card, whose control read 6.914e-5 and planted fault 4.126 (the same
#: in three runs, PERF.md §6)
TC_FLOW_LIMIT_PX = 1e-3
#: refinements at which the TC check reads the flows: from RAFT's 20,
#: where rounding noise has grown as large as a bucketing fault, down to
#: the first, where the check holds them
TC_CHECK_REFINEMENTS = (20, 5, 3, 2, 1)


def flow_gap(torch, exact, other, next_preds):
    """How far the flows ``other`` lie from ``exact``, pair by pair (lists
    of [1, 2, H, W] at the pairs' own size): the largest |difference| in px
    over every pair and both components, the 0.999 quantile of the pairs'
    largest, and the share of the next predictions' pixels (``next_preds``,
    [1, H, W] each) that land elsewhere when nearest-warped by ``other``
    instead of ``exact``."""
    from cvpr2021_vspw_implement_tpu_torch.tc_cal import warp_pred

    gaps = [(o - e).abs() for e, o in zip(exact, other)]
    moved = sum(int((warp_pred(p, e) != warp_pred(p, o)).sum().item())
                for e, o, p in zip(exact, other, next_preds))
    return {"max_abs_px": max(g.max().item() for g in gaps),
            "q999_abs_px": max(torch.quantile(g.flatten(), 0.999).item()
                               for g in gaps),
            "pred_pixels_differ": moved / sum(p.numel() for p in next_preds)}


def tc_flow_check(torch, raft, pairs, next_preds, bucket=64):
    """The check of bucketed TC: for each pair (``pairs`` of [1, 3, H, W]
    images in [0, 255]), RAFT's flow through ``tc_cal.pair_flow``, bucketed
    (``bucket``) and at exact shapes, after the first refinement, held within
    ``TC_FLOW_LIMIT_PX`` on the pair's own size.  With random weights each
    refinement amplifies a difference of rounding (about 7x over the first
    three on the card), so by RAFT's 20th a change of summation order moves
    some pixels by tens of px, as far as a bucketing fault does: the readings at ``TC_CHECK_REFINEMENTS`` are
    printed, the first refinement's held.  Three runs are compared with the
    exact flows:

    * sound: bucketed, the code as shipped;
    * control: exact, with the corr lookup's plain version in place of its
      kernel: the same function summed in another order, no fault;
    * planted: bucketed, with the masked RAFT's re-zero of the
      low-resolution flow's band (``mask_valid``) left out: a bucketing
      fault, which the check must catch.

    Raises SystemExit unless sound and control pass and the planted fault
    fails; returns the readings by refinements."""
    from cvpr2021_vspw_implement_tpu_torch.models.raft import raft as raft_mod
    from cvpr2021_vspw_implement_tpu_torch.ops.corr_lookup import \
        lookup_corr_pyramid_plain
    from cvpr2021_vspw_implement_tpu_torch.tc_cal import pair_flow

    def flows(width_bucket, **swap):
        saved = {k: getattr(raft_mod, k) for k in swap}
        for k, v in swap.items():
            setattr(raft_mod, k, v)
        try:
            return [pair_flow(raft, a, b, width_bucket) for a, b in pairs]
        finally:
            for k, v in saved.items():
                setattr(raft_mod, k, v)

    iters, out = raft.iters, {}
    try:
        for n in TC_CHECK_REFINEMENTS:
            raft.iters = n
            exact = flows(0)
            out[n] = {name: flow_gap(torch, exact, fl, next_preds)
                      for name, fl in (
                          ("sound", flows(bucket)),
                          ("control", flows(0, lookup_corr_pyramid=
                                            lookup_corr_pyramid_plain)),
                          ("planted", flows(bucket, mask_valid=lambda x, hw:
                                            x)))}
    finally:
        raft.iters = iters
    for n, runs in out.items():
        limit = (f"limit {TC_FLOW_LIMIT_PX:g} px on the largest |diff|"
                 if n == 1 else "not held")
        print(f"TC check, bucketed vs exact flow over {len(pairs)} pairs at "
              f"{n} refinement(s) ({limit}): " + "; ".join(
                  f"{name} largest {r['max_abs_px']:.3e} px, 0.999 quantile "
                  f"{r['q999_abs_px']:.3e}, warped prediction pixels moved "
                  f"{r['pred_pixels_differ']:.3e}"
                  for name, r in runs.items()))
    gap = {name: r["max_abs_px"] for name, r in out[1].items()}
    if not (gap["sound"] <= TC_FLOW_LIMIT_PX
            and gap["control"] <= TC_FLOW_LIMIT_PX):
        raise SystemExit("bucketed TC flow disagrees with the exact flow")
    if not gap["planted"] > TC_FLOW_LIMIT_PX:
        raise SystemExit("the TC check missed the planted bucketing fault")
    return out


#: the window methods' train phases: (path, --method, flags, the head
#: parameter that must move, B5 forward (and backward) launches a step of
#: the mode's kernels, the mode, a parameter that only B5's backward
#: reaches: without ``--allsup`` our_warp's emb_2 feeds nothing but B5's
#: x and y_dist; with it, and in our_warp_merge, whose C4 embedding also
#: has its deep supervision, no parameter does); every phase clip_num 4,
#: r = 10, full width
TRAIN_PATHS = (
    ("train_our_warp", "our_warp", ["--allsup", "true"],
     "prop_clip.emb.0.weight", 3, "sigmoid", None),
    ("train_our_warp_softmax", "our_warp", ["--distsoftmax", "true"],
     "prop_clip.emb.0.weight", 3, "softmax", "prop_clip.emb_2.0.weight"),
    ("train_our_warp_nearest", "our_warp", ["--distnearest", "true"],
     "prop_clip.emb.0.weight", 3, "nearest", "prop_clip.emb_2.0.weight"),
    ("train_our_warp_merge", "our_warp_merge", [],
     "prop_clip.emb2.0.weight", 1, "sigmoid", None),
    ("train_propnet", "propnet", [], "segblock.conv1.conv1.weight", 0, None,
     None))

#: the window CLI phases: (path, --method, flags, B5 launches a window of
#: the mode's kernel)
WINDOW_PATHS = (
    ("our_warp", "our_warp", [], 3),
    ("our_warp_softmax", "our_warp", ["--distsoftmax", "true"], 3),
    ("our_warp_nearest", "our_warp", ["--distnearest", "true"], 3),
    ("etc_eval", "ETC", ["--clip_num", "2"], 0),
    ("propnet", "propnet", [], 0),
    ("our_warp_merge", "our_warp_merge", [], 1))


def window_band_launches(torch):
    """The band re-zero's launches in a bucketed window of each path of
    WINDOW_PATHS, derived from the models: the masked trunk's (the input of
    every spatial conv, the stem max pool, each of the 4 levels), C5 in the
    decoder's pyramid, and the head's: the input of each of its spatial
    convs (the feature-level mask; PropNet runs its SegBlock once a context
    frame, 3 a window) and the two embeddings our_warp and our_warp_merge
    re-zero."""
    from cvpr2021_vspw_implement_tpu_torch.models.propnet import SegBlock
    from cvpr2021_vspw_implement_tpu_torch.models.resnet import build_encoder
    from cvpr2021_vspw_implement_tpu_torch.models.warp_our import WarpNet
    from cvpr2021_vspw_implement_tpu_torch.models.warp_our_merge import \
        WarpNetMerge

    def spatial_convs(module):
        return sum(isinstance(m, torch.nn.Conv2d) and max(m.kernel_size) > 1
                   for m in module.modules())

    base = spatial_convs(build_encoder("resnet101dilated")) + 1 + 4 + 1
    warp = base + spatial_convs(WarpNet(124, 4)) + 2
    return {"our_warp": warp, "our_warp_softmax": warp,
            "our_warp_nearest": warp, "etc_eval": base,
            # PropNet's emb and emb2, then 3 SegBlocks
            "propnet": base + 2 + 3 * spatial_convs(SegBlock(124)),
            "our_warp_merge": base + spatial_convs(WarpNetMerge(124, 1024))
            + 2}


def capture_window_logits(test_clip, captured):
    """Wrap ``test_clip``'s prediction heads so that each window's logits
    (exact: ``inference_pred``; bucketed: ``inference_pred_rt``) are kept
    in ``captured`` with the arguments of their resize, and our_warp's
    nearest aggregation so that each window also keeps the union of its
    aggregations' near-tie positions (:func:`near_ties`, at the feature
    level; None for the other modes).  Returns what
    :func:`restore_window_heads` puts back."""
    import torch

    from cvpr2021_vspw_implement_tpu_torch.models import warp_our
    from cvpr2021_vspw_implement_tpu_torch.ops.local_pairwise import \
        local_pairwise_dist

    saved = (test_clip.inference_pred, test_clip.inference_pred_rt,
             warp_our.local_nearest_aggregate)
    ties = []

    def nearest(x, y_dist, y_val, r, valid_hw=None):
        ties.append(near_ties(local_pairwise_dist(x, y_dist, r, valid_hw)))
        return saved[2](x, y_dist, y_val, r, valid_hw=valid_hw)

    def window_ties():
        if not ties:
            return None
        out = torch.stack(ties).any(0)
        ties.clear()
        return out

    def exact(outputs, size, *args, **kw):
        captured.append((outputs[0].detach().clone(), size, window_ties()))
        return saved[0](outputs, size, *args, **kw)

    def bucketed(logits, pad, fv, hw, *args, **kw):
        captured.append((logits.detach().clone(), pad, fv, hw,
                         window_ties()))
        return saved[1](logits, pad, fv, hw, *args, **kw)

    test_clip.inference_pred, test_clip.inference_pred_rt = exact, bucketed
    warp_our.local_nearest_aggregate = nearest
    return saved


def restore_window_heads(test_clip, saved):
    from cvpr2021_vspw_implement_tpu_torch.models import warp_our

    (test_clip.inference_pred, test_clip.inference_pred_rt,
     warp_our.local_nearest_aggregate) = saved


def window_bucket_check(torch, path, exact, bucketed, exact_pngs,
                        bucket_pngs, align_corners=False):
    """A window CLI phase bucketed against its exact run, with the bars of
    :func:`bucketed_vs_exact`: the upsampled logits on the valid region
    within 1e-3 of the largest exact logit, and the PNGs equal but at
    pixels whose exact top-2 margin is below that tolerance.  ``exact`` and
    ``bucketed``: the captured logits of each window.  For nearest, the
    value at the window's argmax is a step function of the distances: a
    pixel whose logits read a feature position where either run's
    aggregation had a near-tie (the two largest distances within 1e-4
    relative, where rounding may flip the pick, as in the kernel checks) is
    excused from both bars, and the count printed.  ``align_corners``:
    the logits' upsampling (TDNet's is ``True``)."""
    from cvpr2021_vspw_implement_tpu_torch.ops.interpolate import \
        resize_bilinear
    from cvpr2021_vspw_implement_tpu_torch.ops.masked import \
        resize_bilinear_rt

    def up_exact(i):
        logits, size, _ = exact[i]
        return resize_bilinear(logits.float(), size,
                               align_corners=align_corners)[0]

    def up_bucketed(i):
        logits, pad, fv, (h, w), _ = bucketed[i]
        return resize_bilinear_rt(logits.float(), pad, fv, (h, w),
                                  align_corners=align_corners)[0, :, :h, :w]

    def touched(i):
        """Pixels whose logits read a near-tie feature position of window
        i, and the number of such positions."""
        tie_e, size = exact[i][2], exact[i][1]
        if tie_e is None:
            return None, 0
        fh, fw = tie_e.shape[-2:]
        tie = tie_e | bucketed[i][4][..., :fh, :fw]
        up = resize_bilinear(tie[:, None].float(), size)[0, 0] > 0
        return up, int(tie.sum().item())

    n = len(exact)
    if len(bucketed) != n or n != len(exact_pngs):
        raise SystemExit(f"{path}: captured {n} exact and {len(bucketed)} "
                         f"bucketed windows for {len(exact_pngs)} frames")
    tol = 1e-3 * max(up_exact(i).abs().max().item() for i in range(n))
    err, diff, excused, ties, tie_pixels = 0.0, 0, 0, 0, 0
    for i in range(n):
        e, b = up_exact(i), up_bucketed(i)
        gap = (b - e).abs().amax(0)
        top = e.topk(2, dim=0).values
        near = top[0] - top[1] < tol
        skip, n_ties = touched(i)
        if skip is not None:
            gap = gap[~skip]
            near |= skip
            ties += n_ties
            tie_pixels += int(skip.sum().item())
        if gap.numel():
            err = max(err, gap.max().item())
        differ = exact_pngs[i] != bucket_pngs[i]
        diff += int(differ.sum())
        excused += int((differ & near.cpu().numpy()).sum())
    pixels = n * exact_pngs[0].size
    tie_text = (f"; {ties} near-tie feature positions, {tie_pixels} pixels "
                "reading them excused" if exact[0][2] is not None else "")
    print(f"{path} bucketed vs exact window eval: logits on the valid region "
          f"max |diff| {err:.3e} (limit {tol:.3e}, 1e-3 of the largest exact "
          f"logit); PNGs differ at {diff} of {pixels} pixels, {excused} of "
          f"them excused (exact top-2 margin below the limit){tie_text}")
    if not (err <= tol and diff == excused):
        raise SystemExit(f"{path}: bucketed window eval disagrees with exact")
    return {"logit_err": err, "logit_tol": tol, "pixels_differ": diff,
            "pixels_excused": excused, "near_tie_positions": ties,
            "near_tie_pixels": tie_pixels}


#: every key of the bench's rows (cvpr2021_vspw_implement_tpu_torch/bench.py)
BENCH_KEYS = (
    "value", "mfu", "metric", "unit", "stream4_frames_per_sec",
    "stream_bucketed_frames_per_sec", "stream_bucketed_overhead_pct",
    "baseline_frames_per_sec", "vs_baseline", "baseline_mfu",
    "train_step_ms", "train_step_single_readback_ms", "train_mfu",
    "train_peak_mem_gib", "etc_train_step_ms", "etc_train_mfu",
    "our_warp_train_step_ms", "our_warp_train_mfu",
    "etc_windows_per_sec", "etc_mfu", "etc_bucketed_windows_per_sec",
    "our_warp_windows_per_sec", "our_warp_mfu",
    "our_warp_bucketed_windows_per_sec", "propnet_windows_per_sec",
    "propnet_mfu", "our_warp_merge_windows_per_sec", "our_warp_merge_mfu",
    "tc_ms_per_pair", "tc_bucketed_ms_per_pair", "tc_mfu",
    "clipocr_frames_per_sec", "clipocr_mfu", "clipocr_stream4_frames_per_sec",
    "clipocr_bucketed_frames_per_sec", "clipocr_bucketed_overhead_pct",
    "netwarp_stream_frames_per_sec", "netwarp_stream_mfu",
    "netwarp_stream_bucketed_frames_per_sec", "netwarp_train_step_ms",
    "netwarp_train_mfu", "tdnet_frames_per_sec", "tdnet_mfu",
    "tdnet_stream4_frames_per_sec", "tdnet_bucketed_frames_per_sec",
    "tdnet_bucketed_overhead_pct", "nonlocal3d_windows_per_sec",
    "nonlocal3d_mfu", "hrnet_frames_per_sec", "hrnet_mfu",
    "hrnet_bucketed_frames_per_sec", "hrnet_bucketed_overhead_pct",
    "hrnetclip_windows_per_sec", "hrnetclip_mfu", "ocr_head_ms",
    "ocr_head_mfu", "ocr_head_shape",
    "host_decode_frames_per_sec", "host_decode_path",
    "host_cores_to_saturate_chip", "spreads_pct", "device", "power_limit_w",
    "peak_tflops_f32", "dtype", "not_ported")
#: the bench's times and rates, each finite and positive
BENCH_TIMES = (
    "value", "stream4_frames_per_sec", "stream_bucketed_frames_per_sec",
    "baseline_frames_per_sec", "vs_baseline", "train_step_ms",
    "train_step_single_readback_ms", "etc_train_step_ms",
    "our_warp_train_step_ms", "etc_windows_per_sec",
    "etc_bucketed_windows_per_sec",
    "our_warp_windows_per_sec", "our_warp_bucketed_windows_per_sec",
    "propnet_windows_per_sec", "our_warp_merge_windows_per_sec",
    "tc_ms_per_pair", "tc_bucketed_ms_per_pair",
    "clipocr_frames_per_sec", "clipocr_stream4_frames_per_sec",
    "clipocr_bucketed_frames_per_sec", "netwarp_stream_frames_per_sec",
    "netwarp_stream_bucketed_frames_per_sec", "netwarp_train_step_ms",
    "tdnet_frames_per_sec", "tdnet_stream4_frames_per_sec",
    "tdnet_bucketed_frames_per_sec", "nonlocal3d_windows_per_sec",
    "hrnet_frames_per_sec", "hrnet_bucketed_frames_per_sec",
    "hrnetclip_windows_per_sec", "ocr_head_ms",
    "host_decode_frames_per_sec", "host_cores_to_saturate_chip")
BENCH_MFUS = ("mfu", "baseline_mfu", "train_mfu", "etc_train_mfu",
              "our_warp_train_mfu", "etc_mfu", "our_warp_mfu", "propnet_mfu",
              "our_warp_merge_mfu", "tc_mfu", "clipocr_mfu",
              "netwarp_stream_mfu", "netwarp_train_mfu", "tdnet_mfu",
              "nonlocal3d_mfu", "hrnet_mfu", "hrnetclip_mfu", "ocr_head_mfu")


def check_bench(out, per_frame, per_pair, iters, per_window, per_ocr):
    """The bench's result on the card: every key; every time and rate
    finite and positive; every ``mfu`` in (0, 1]; and each row's kernel
    launches in a trial as its loop implies: a bucketed frame ``per_frame``
    B6 launches, an ETC or NetWarp step ``iters`` each of B1, B2 and B3, an
    our_warp window 3 of B5 (sigmoid), an our_warp train step 3 of B5 and 3
    of its backward (sigmoid), an our_warp_merge window 1, a bucketed
    window ``per_window`` (by path) of B6, a TC pair and a NetWarp frame
    ``iters`` of B1 and twice that of B4 (and bucketed ``per_pair`` and
    ``per_ocr["netwarp"]`` of B6), a bucketed TCB-OCR frame
    ``per_ocr["clip_ocr"]`` of B6, a bucketed TDNet frame
    ``per_ocr["tdnet"]``, a bucketed HRNet frame ``per_ocr["hrnet"]``; no
    other launch."""
    missing = [k for k in BENCH_KEYS if k not in out]
    bad = [k for k in BENCH_TIMES
           if not (math.isfinite(out[k]) and out[k] > 0)]
    bad += [k for k in BENCH_MFUS if not (out[k] is not None
                                          and 0 < out[k] <= 1)]
    n = out["counts"]
    tc = {"corr_lookup": iters * n["pairs"], "sep_gru": 2 * iters * n["pairs"]}
    m = n["windows"]
    want = {"stream_bucketed": {"band_zero": per_frame * n["frames"]},
            "etc_train": {k: iters * n["etc_train_steps"] for k in (
                "corr_lookup", "motion_encoder", "gru_flowhead")},
            "etc_bucketed": {"band_zero": per_window["etc_eval"] * m},
            "our_warp": {"local_sigmoid_aggregate": 3 * m},
            "our_warp_bucketed": {"local_sigmoid_aggregate": 3 * m,
                                  "band_zero": per_window["our_warp"] * m},
            "our_warp_merge": {"local_sigmoid_aggregate": m},
            "our_warp_train": {k: 3 * n["train_steps"] for k in (
                "local_sigmoid_aggregate",
                "local_sigmoid_aggregate_backward")},
            "tc": tc,
            "tc_bucketed": {**tc, "band_zero": per_pair * n["pairs"]},
            "clipocr_bucketed": {
                "band_zero": per_ocr["clip_ocr"] * n["frames"]},
            "tdnet_bucketed": {"band_zero": per_ocr["tdnet"] * n["frames"]},
            "hrnet_bucketed": {"band_zero": per_ocr["hrnet"] * n["frames"]},
            "netwarp_train": {k: iters * n["etc_train_steps"] for k in (
                "corr_lookup", "motion_encoder", "gru_flowhead")},
            "netwarp_stream": {"corr_lookup": iters * n["frames"],
                               "sep_gru": 2 * iters * n["frames"]},
            "netwarp_stream_bucketed": {
                "corr_lookup": iters * n["frames"],
                "sep_gru": 2 * iters * n["frames"],
                "band_zero": per_ocr["netwarp"] * n["frames"]}}
    wrong = {row: got for row, got in out["launches"].items()
             if got != {k: want.get(row, {}).get(k, 0) for k in got}}
    print(f"bench check: every key present (missing {missing}); times, "
          f"rates and mfu out of range {bad}; rows whose launches differ "
          f"from the derived counts {wrong}")
    if missing or bad or wrong:
        raise SystemExit("the bench's result fails its check")


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


def clip_warp_agreement(torch):
    """ClipWarpNet (ResNet-18-dilated, 124 classes, r = 3 over 16x24
    features) in each aggregation mode on the card, through the kernels,
    and on the CPU, through their plain versions.  The context frames are
    the target shifted by whole feature pixels plus noise, and emb_2's
    BatchNorm scale is set so the median window distance is 2 (sigmoid,
    nearest) or 0.3 (softmax): the match then weighs far more than the rest
    of its window.  Each context frame's aggregation, on the CPU's
    embeddings, within 1e-4 of its largest value (nearest: equal off
    near-ties); logits within 1e-4 of their range, at exact shapes and
    width-bucketed (the frames cut to 120x176 in the 128x192 bucket; the
    valid region)."""
    from cvpr2021_vspw_implement_tpu_torch.models.layers import init_weights
    from cvpr2021_vspw_implement_tpu_torch.models.resnet import build_encoder
    from cvpr2021_vspw_implement_tpu_torch.models.warp_our import (
        ClipWarpNet, warp_one_scale)
    from cvpr2021_vspw_implement_tpu_torch.ops.local_pairwise import \
        local_pairwise_dist
    from cvpr2021_vspw_implement_tpu_torch.ops.masked import pad_to

    g = torch.Generator().manual_seed(6)
    base = torch.randn(1, 3, 128, 192, generator=g)
    imgs = torch.stack([torch.roll(base, (8 * s, -8 * s), (2, 3))
                        + 0.1 * torch.randn(1, 3, 128, 192, generator=g)
                        for s in (3, 2, 1, 0)])        # target last, unshifted
    for mode, median in (("sigmoid", 2.0), ("softmax", 0.3),
                         ("nearest", 2.0)):
        model = ClipWarpNet(build_encoder("resnet18dilated"), 124, fc_dim=512,
                            max_distances=(3,),
                            distsoftmax=mode == "softmax",
                            distnearest=mode == "nearest")
        init_weights(model, torch.Generator().manual_seed(7))
        model.eval()
        head = model.prop_clip
        flags = (3, mode == "softmax", mode == "nearest")
        with torch.inference_mode():
            _, embs, _ = model.decoder(model.encoder(imgs.flatten(0, 1)))
            dist = local_pairwise_dist(head.emb_2(embs)[-1:],
                                       head.emb_2(embs)[:1], 3)
            scale = (median / dist[dist < 1e19].median()).sqrt()
            head.emb_2[1].weight.mul_(scale)
            head.emb_2[1].bias.mul_(scale)
            e2, es = head.emb_2(embs), head.emb(embs)
            spread = "{:.4g}/{:.4g}/{:.4g}".format(*weight_spread(
                torch, local_pairwise_dist(e2[-1:], e2[:1], 3), mode))
            err, bad, excused = 0.0, 0, 0
            for f in range(3):
                args = (e2[-1:], e2[f:f + 1], es[f:f + 1])
                want = warp_one_scale(*args, *flags)
                got = warp_one_scale(*(a.cuda() for a in args), *flags).cpu()
                err = max(err, ((got - want).abs().max()
                                / want.abs().max()).item())
                if mode == "nearest":
                    tie = near_ties(local_pairwise_dist(*args[:2], 3))
                    bad += int(((got != want).any(1) & ~tie).sum())
                    excused += int(tie.sum())
            cpu = model(imgs)[0]
            gpu = model.cuda()(imgs.cuda())[0].cpu()
        rel = ((cpu - gpu).abs().max() / (cpu.max() - cpu.min())).item()
        if mode == "nearest":
            agg = (f"{bad} mismatching positions of {3 * 16 * 24} after "
                   f"excusing {excused} near-ties")
            err = 0.0 if bad == 0 else float("inf")
        else:
            agg = (f"max |diff| / max |plain| = {err:.3e} (largest over mean "
                   f"window weight, quantiles 0.1/0.5/0.9: {spread})")
        # width-bucketed: the frames cut to 120x176 and padded back to
        # 128x192 (the 64-column bucket): features 16x24, 15x22 valid
        padded = pad_to(imgs[..., :120, :176], (128, 192))
        with torch.inference_mode():
            gpu = model(padded.cuda(), valid_hw=(120, 176))[0].cpu()
            cpu = model.cpu()(padded, valid_hw=(120, 176))[0]
        gpu, cpu = gpu[..., :15, :22], cpu[..., :15, :22]
        rel_b = ((cpu - gpu).abs().max() / (cpu.max() - cpu.min())).item()
        print(f"ClipWarpNet ({mode}): aggregations kernel vs plain on the "
              f"model's embeddings, {agg}; logits card vs CPU, max |diff| / "
              f"range = {rel:.3e}, bucketed (120x176 in 128x192, on the "
              f"valid region) {rel_b:.3e} (limits 1e-4)")
        if not (err <= 1e-4 and rel <= 1e-4 and rel_b <= 1e-4):
            raise SystemExit(f"ClipWarpNet ({mode}) on the card disagrees "
                             "with the CPU")


def train_step_agreement(torch):
    """One ETC train step (ResNet-18-dilated, RAFT with 2 refinements,
    dropout off, batch 4) on the card, through the kernels, and on the CPU,
    through their plain versions: the loss and the norm of the classifier's
    gradient agree within 1e-3 relative."""
    from cvpr2021_vspw_implement_tpu_torch.models import layers
    from cvpr2021_vspw_implement_tpu_torch.models.etc import ETC, etc_loss
    from cvpr2021_vspw_implement_tpu_torch.models.resnet import build_encoder

    g = torch.Generator().manual_seed(4)
    model = ETC(build_encoder("resnet18dilated"), 124, fc_dim=512,
                raft_iters=2)
    layers.init_weights(model, torch.Generator().manual_seed(5))
    model.train()
    batch = {"img": torch.randn(2, 4, 3, 71, 71, generator=g),
             "labels": torch.randint(0, 124, (2, 4, 71, 71), generator=g)}
    layers.set_dropout_override(0.0)
    out = []
    for dev in ("cpu", "cuda"):
        model.to(dev).zero_grad()
        on_dev = {k: v.to(dev) for k, v in batch.items()}
        loss, _ = etc_loss(model(on_dev["img"]), on_dev)
        loss.backward()
        out.append((loss.item(),
                    model.conv_last_[4].weight.grad.norm().item()))
    layers.set_dropout_override(None)
    (l0, g0), (l1, g1) = out
    print(f"ETC train step card vs CPU: loss {l1:.6f} vs {l0:.6f}, "
          f"classifier gradient norm {g1:.6f} vs {g0:.6f} (limit 1e-3 "
          "relative)")
    if not (abs(l1 - l0) <= 1e-3 * abs(l0) and abs(g1 - g0) <= 1e-3 * g0):
        raise SystemExit("the train step on the card disagrees with the CPU")


#: the BatchNorm scale of each window method's distance embedding, which
#: the smoke's training checks set (all channels) before the first step:
#: at the default init (1) the embeddings' squared distances sum over 128
#: or 256 channels of unit size, the sigmoid saturates and B5's smooth
#: gradients are exactly 0 in f32, which any backward would match; at 0.05
#: they lie where the sigmoid and the softmax scores have a slope (a
#: trained-like start, as the TC phases scale RAFT's flow head)
DIST_BN = {"our_warp": "prop_clip.emb_2.1.weight",
           "our_warp_merge": "prop_clip.emb2.1.weight"}
DIST_BN_SCALE = 0.05


@contextlib.contextmanager
def recorded_backward(mode, sink, keep=False):
    """While open, each backward of B5's ``mode`` (its autograd Function in
    ``ops/local_agg.py``, which calls the backward wrapper) appends the
    gradients it returns to ``sink``: their norms, or with ``keep``
    detached copies."""
    from cvpr2021_vspw_implement_tpu_torch.ops import local_agg

    cls = {"sigmoid": local_agg._SigmoidAggregate,
           "softmax": local_agg._SoftmaxAggregate,
           "nearest": local_agg._NearestAggregate}[mode]
    backward = cls.backward

    def recorded(ctx, *grads):
        out = backward(ctx, *grads)
        sink.append([t.detach().clone() if keep else t.detach().norm()
                     for t in out if t is not None])
        return out

    cls.backward = staticmethod(recorded)
    try:
        yield
    finally:
        cls.backward = staticmethod(backward)


def rel_gap(got, want) -> float:
    """max |got - want| / max |want|, ``got`` moved to ``want``'s device;
    raises where ``want`` is all zero, which any ``got`` of zeros would
    match."""
    scale = want.abs().max().item()
    if not scale > 0:
        raise SystemExit("a gradient held card against CPU is all zero")
    return (got.to(want.device) - want).abs().max().item() / scale


def warp_train_agreement(torch):
    """One our_warp train step (ResNet-18-dilated, 124 classes, clip_num 4,
    batch 2, 64x96, r = 3, dropout off, no ``allsup``) on the card, through
    B5's forward and backward kernels, and on the CPU, through the plain
    versions, in the sigmoid and softmax modes, ``emb_2``'s BatchNorm
    scale at DIST_BN_SCALE.  Without ``allsup`` the distance embedding
    ``emb_2`` is reached only through B5's dx and dy_dist.  Held within
    1e-3 relative: the loss; each of the 3 backward calls' gradients (dx,
    dy_dist, dy_val) element by element, against the largest element, none
    all zero; the gradients of ``emb_2``'s and ``emb``'s conv weights
    element by element; the norm of the encoder's first conv's gradient.
    (Nearest's picks are a step function of the embeddings, which cuDNN
    and the CPU round apart.)"""
    from cvpr2021_vspw_implement_tpu_torch.models import layers
    from cvpr2021_vspw_implement_tpu_torch.models.resnet import build_encoder
    from cvpr2021_vspw_implement_tpu_torch.models.warp_our import (
        ClipWarpNet, clip_warp_loss)
    from cvpr2021_vspw_implement_tpu_torch.ops import local_agg

    g = torch.Generator().manual_seed(9)
    batch = {"img": torch.randn(4, 2, 3, 64, 96, generator=g),
             "labels": torch.randint(0, 124, (4, 2, 64, 96), generator=g)}
    watched = ("prop_clip.emb_2.0.weight", "prop_clip.emb.0.weight")
    layers.set_dropout_override(0.0)
    try:
        for mode in ("sigmoid", "softmax"):
            model = ClipWarpNet(build_encoder("resnet18dilated"), 124,
                                fc_dim=512, max_distances=(3,),
                                distsoftmax=mode == "softmax")
            layers.init_weights(model, torch.Generator().manual_seed(10))
            with torch.no_grad():
                model.get_parameter(DIST_BN["our_warp"]).fill_(DIST_BN_SCALE)
            bwd = getattr(local_agg, f"local_{mode}_aggregate_backward")
            out = {}
            for dev in ("cpu", "cuda"):
                model.to(dev).train().zero_grad()
                launches, calls = bwd.launches, []
                on_dev = {k: v.to(dev) for k, v in batch.items()}
                with recorded_backward(mode, calls, keep=True):
                    loss, _ = clip_warp_loss(model(on_dev["img"]), on_dev)
                    loss.backward()
                params = dict(model.named_parameters())
                out[dev] = (loss.item(), calls,
                            [params[n].grad.clone() for n in watched],
                            model.encoder.conv1.weight.grad.norm().item())
                if (len(calls) != 3 or (bwd.launches - launches)
                        != (3 if dev == "cuda" else 0)):
                    raise SystemExit(f"our_warp ({mode}) step on {dev}: "
                                     f"{len(calls)} backward calls, "
                                     f"{bwd.launches - launches} launches")
            (l0, calls0, p0, n0), (l1, calls1, p1, n1) = (out["cpu"],
                                                          out["cuda"])
            call_gaps = [max(rel_gap(a, e) for a, e in zip(c1, c0))
                         for c1, c0 in zip(calls1, calls0)]
            param_gaps = [rel_gap(a, e) for a, e in zip(p1, p0)]
            scalar_gaps = [abs(l1 - l0) / abs(l0), abs(n1 - n0) / n0]
            print(f"our_warp ({mode}) train step card vs CPU: loss {l1:.6f} "
                  f"vs {l0:.6f}; B5 backward gradients, largest gap a call "
                  f"{['%.3e' % v for v in call_gaps]}; gradients of "
                  f"{', '.join(watched)}: {['%.3e' % v for v in param_gaps]} "
                  f"(norms {[round(t.norm().item(), 6) for t in p0]}); "
                  f"encoder.conv1 gradient norm {n1:.6f} vs {n0:.6f} "
                  "(limit 1e-3 relative each)")
            if not max(call_gaps + param_gaps + scalar_gaps) <= 1e-3:
                raise SystemExit(f"the our_warp ({mode}) train step on the "
                                 "card disagrees with the CPU")
    finally:
        layers.set_dropout_override(None)


def train_phase(torch, method, flags, root, work, preset, k, steps,
                head=None, name=None, b5=None, b5_only=None, encoder=None):
    """``steps`` steps of ``train_clip.main`` at full width; prints step
    times, losses and peak memory and returns the model.  Fails unless the
    losses are finite, a head parameter (``head``, or the first one named
    ``*.4.weight``) and an encoder parameter moved and RAFT did not.
    ``b5``: the mode of B5 the path trains through; every call of its
    backward must then give finite gradients, and each of its gradients
    (dx, dy_dist, dy_val; nearest: dy_val) must be nonzero in some call.
    ``b5_only``: a parameter that only B5's backward reaches; its last
    step's gradient must be finite and not all zero, or all zero for
    nearest, which gives x and y_dist none.  A window method's distance
    embedding starts at DIST_BN_SCALE.  ``encoder``: the encoder parameter
    to watch, else the first ``encoder.*``.  TDNet's ``pos_id`` of each
    step is printed and held to the trainer's rotation, (step + 1) % 4."""
    from cvpr2021_vspw_implement_tpu_torch import train_clip

    records, spans, before, b5_grads, pos_ids = [], [], {}, [], []
    step = train_clip.train_step

    def watched(model):
        named = dict(model.named_parameters())
        names = [encoder] if encoder else [
            n for n in named if n.startswith("encoder.")][:1]
        names += [head] if head else [
            n for n in named if n.endswith(".4.weight")][:1]
        names += [n for n in named if n.startswith("raft.")][:1]
        return {n: named[n] for n in names}

    def timed_step(model, *args, **kw):
        if "pos_id" in kw:
            pos_ids.append(kw["pos_id"])
        if not before:
            if method in DIST_BN:
                with torch.no_grad():
                    model.get_parameter(DIST_BN[method]).fill_(DIST_BN_SCALE)
            before.update({n: p.detach().clone()
                           for n, p in watched(model).items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(model, *args, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        records.append((t1 - t0, float(metrics["loss"])))
        spans.append((t0, t1))
        return metrics

    torch.cuda.reset_peak_memory_stats()
    train_clip.train_step = timed_step
    try:
        with (recorded_backward(b5, b5_grads) if b5
              else contextlib.nullcontext()):
            model = train_clip.main([
            "--cfg", preset, "--dataroot", root, "--num_class", str(k),
                "--method", method, *flags, "--batchsize", "2",
                "--cropsize", "479", "--lr", "0.002", "--totalepoch",
                str(steps // 2), "--saveroot",
                os.path.join(work, "ckpt_" + (name or method)), "--seed", "0",
                "DIR", os.path.join(work, "cfg_" + (name or method))])
    finally:
        train_clip.train_step = step
    peak = torch.cuda.max_memory_allocated()
    times = [t for t, _ in records]
    losses = [loss for _, loss in records]
    if len(records) != steps or not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"{method}: {len(records)} steps, losses {losses}")
    if method == "tdnet":
        if pos_ids != [(i + 1) % 4 for i in range(steps)]:
            raise SystemExit(f"tdnet: the steps' pos_id {pos_ids}")
        print(f"tdnet: pos_id of the steps {pos_ids}")
    for pname, p in watched(model).items():
        moved = not torch.equal(p.detach(), before[pname])
        if moved == pname.startswith("raft."):
            raise SystemExit(f"{method}: parameter {pname} "
                             f"{'moved' if moved else 'did not move'}")
    # [call][gradient]: a call may rightly give zeros (a softmax window
    # whose weight is one-hot), every gradient of the phase may not
    norms = [[v.item() for v in call] for call in b5_grads]
    largest = [max(v) for v in zip(*norms)]
    if b5 and not (largest and min(largest) > 0 and all(
            math.isfinite(v) for call in norms for v in call)):
        raise SystemExit(f"{name or method}: B5's {b5} backward gave "
                         f"{len(b5_grads)} calls, gradient norms {norms}")
    if b5_only:
        grad = dict(model.named_parameters())[b5_only].grad
        nonzero = int(torch.count_nonzero(grad).item())
        if (not torch.isfinite(grad).all().item()
                or (nonzero == 0) != (b5 == "nearest")):
            raise SystemExit(f"{name or method}: {b5_only}, reached only "
                             f"through B5's backward, has a gradient with "
                             f"{nonzero} nonzero elements")
    if b5:
        none = ", which gives it none in nearest" if b5 == "nearest" else ""
        print(f"{name or method}: {len(b5_grads)} calls of B5's {b5} "
              f"backward, the largest norm of each gradient "
              f"{['%.4g' % v for v in largest]}, calls with a gradient all "
              f"zero {sum(min(call) == 0 for call in norms)}" + (
                  f"; {b5_only} (reached only through B5{none}) has a "
                  f"gradient of norm {grad.norm().item():.4g}"
                  if b5_only else ""))
    waits = data_waits_ms(spans, 2)
    print(f"train {name or method} (crop 479, batch 2, f32): first step "
          f"{1e3 * times[0]:.1f} ms, then "
          f"{1e3 * sum(times[1:]) / (steps - 1):.1f} ms/step over "
          f"{steps - 1} steps; data wait inside an epoch "
          f"{[round(w, 1) for w in waits]} ms; losses "
          f"{[round(v, 4) for v in losses]}; peak memory "
          f"{peak / 2 ** 30:.2f} GiB")
    return model


def native_host_ops(root):
    """Which path the native host ops took (``native.status``), and their
    host time a 480x853 frame beside their numpy path's on the fixture's
    frames (best of ``HOSTOPS_TRIALS`` over the frames).  Fails if ``g++``
    is present and ``hostops`` did not build, or if an array differs from
    numpy's."""
    import shutil

    import numpy as np
    from PIL import Image

    from cvpr2021_vspw_implement_tpu_torch import native

    status = native.status()
    frames, masks = [], []
    for video in sorted(os.listdir(os.path.join(root, "data"))):
        vdir = os.path.join(root, "data", video)
        for name in sorted(os.listdir(os.path.join(vdir, "origin"))):
            frames.append(np.asarray(Image.open(
                os.path.join(vdir, "origin", name)).convert("RGB")))
            masks.append(np.asarray(Image.open(os.path.join(
                vdir, "mask", os.path.splitext(name)[0] + ".png"))))
    same = all(np.array_equal(native.normalize_u8(f),
                              native.normalize_numpy(f)) for f in frames) \
        and all(np.array_equal(native.remap_label_u8(m),
                               native.remap_numpy(m)) for m in masks)

    def best_ms(fn, arrays):
        best = float("inf")
        for _ in range(HOSTOPS_TRIALS):
            t0 = time.perf_counter()
            for a in arrays:
                fn(a)
            best = min(best, time.perf_counter() - t0)
        return 1e3 * best / len(arrays)

    ms = {"normalize_ms": best_ms(native.normalize_u8, frames),
          "normalize_numpy_ms": best_ms(native.normalize_numpy, frames),
          "remap_ms": best_ms(native.remap_label_u8, masks),
          "remap_numpy_ms": best_ms(native.remap_numpy, masks)}
    print(f"native host ops: hostops {status}; bitwise numpy's on "
          f"{len(frames)} frames and masks: {same}; host ms a 480x853 frame "
          f"(best of {HOSTOPS_TRIALS}): normalize {ms['normalize_ms']:.3f} "
          f"(numpy {ms['normalize_numpy_ms']:.3f}), label remap "
          f"{ms['remap_ms']:.3f} (numpy {ms['remap_numpy_ms']:.3f}); "
          f"host cores {os.cpu_count()}")
    if shutil.which("g++") and status != "native":
        raise SystemExit(f"g++ is present and hostops did not build: "
                         f"{status}")
    if not same:
        raise SystemExit("the native host ops differ from their numpy path")
    return {"hostops": status, "bitwise_numpy": same, **ms}


#: passes over the fixture's frames when the host ops are timed
HOSTOPS_TRIALS = 5


def step_timer(module, records):
    """``module.train_step`` wrapped to append (start, end, loss) on the
    host clock, synchronised, to ``records``; returns the original."""
    import torch

    step = module.train_step

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(*args)
        torch.cuda.synchronize()
        records.append((t0, time.perf_counter(), float(metrics["loss"])))
        return metrics

    module.train_step = timed
    return step


def data_waits_ms(records, per_epoch):
    """The host time from one step's end to the next one's start inside an
    epoch (the wait for a batch on the card; the first step of an epoch
    also waits for the loader's start, and the epoch's end for its
    checkpoint, so they are left out)."""
    return [1e3 * (records[i][0] - records[i - 1][1])
            for i in range(1, len(records)) if i % per_epoch]


#: the per-frame baseline's preset (PSPNet: ResNet-101-dilated + ppm_deepsup)
FRAME_PRESET = os.path.join(REPO, "cvpr2021_vspw_implement_tpu_torch",
                            "config", "presets",
                            "vsp-resnet101dilated-ppm_deepsup.yaml")


def frame_band_launches(torch, arch="resnet101dilated"):
    """B6's launches a frame of the per-frame ``ppm_deepsup`` model's
    bucketed eval where every level has a band
    (:func:`frame_model_band_launches`: the trunk's spatial convs, the stem
    max pool, the four levels and C5 again in the pyramid)."""
    from cvpr2021_vspw_implement_tpu_torch.models.builder import ModelBuilder
    from cvpr2021_vspw_implement_tpu_torch.models.segmentation import \
        SegmentationModule

    with torch.device("meta"):
        return frame_model_band_launches(torch, SegmentationModule(
            ModelBuilder.build_encoder(arch),
            ModelBuilder.build_decoder("ppm_deepsup")))


def frame_eval_phase(torch, root, work, k, n_frames, reset, counts,
                     preset=FRAME_PRESET, name="frame_eval",
                     label="R101 ppm_deepsup", per_frame=None, load="",
                     fault=None, opts=()):
    """f (and m, o). The per-frame eval CLI (``test``) over the 10-frame
    video with a seeded random model of ``preset`` (default R101
    ``ppm_deepsup``; ``load``: a checkpoint of it instead), exact
    (``--width_bucket 0``) then at its default, bucketed in 480x896: PNGs
    and finite mIoU, no kernel exact and B6 at ``per_frame`` a frame
    bucketed (default :func:`frame_band_launches`), the bucketed logits held
    against the exact ones as the clip phases hold them (within 1e-3 of the
    largest, PNGs equal off near-ties), and a frame's forward and argmax
    timed on CUDA events beside its operations (``FlopCounterMode``) and
    mfu against the f32 peak.  ``fault``: a context manager factory that
    plants a fault; a bucketed run under it must fail the same check.
    ``opts``: trailing ``KEY VALUE`` overrides of the preset.  Returns
    (launches by path, checks)."""
    import numpy as np
    from PIL import Image

    from torch.utils.flop_counter import FlopCounterMode

    from cvpr2021_vspw_implement_tpu_torch import test as frame_test
    from cvpr2021_vspw_implement_tpu_torch.bench import PEAK_F32_FLOPS
    from cvpr2021_vspw_implement_tpu_torch.config import cfg as default_cfg
    from cvpr2021_vspw_implement_tpu_torch.data import TestFrameDataset
    from cvpr2021_vspw_implement_tpu_torch.ops.interpolate import \
        resize_bilinear
    from cvpr2021_vspw_implement_tpu_torch.ops.masked import (
        bucket_hw, resize_bilinear_rt)

    args = frame_test.build_eval_parser().parse_args(
        ["--cfg", preset, "--num_class", str(k), "--seed", "0"]
        + (["--load", load] if load else []) + list(opts))
    img = TestFrameDataset(root, "video_000", args)[0][0]
    hw = img.shape[:2]
    key = bucket_hw(*hw)
    if per_frame is None:
        per_frame = frame_band_launches(torch)
    captured = []
    saved = frame_test.inference_pred, frame_test.inference_pred_rt

    def exact_pred(outs, size):
        captured.append(resize_bilinear(outs[0].float(), size)[0])
        return saved[0](outs, size)

    def bucket_pred(logits, pad, fv, hw):
        captured.append(resize_bilinear_rt(logits.float(), pad, fv, hw)[
            0, :, :hw[0], :hw[1]])
        return saved[1](logits, pad, fv, hw)

    def run(bucket, tag=""):
        """One CLI run → (captured logits, PNGs, metrics); its launches
        held and kept unless ``tag``."""
        path = name + tag + ("_bucketed" if bucket else "")
        out = os.path.join(work, "preds_" + path)
        reset()
        t0 = time.perf_counter()
        frame_test.inference_pred, frame_test.inference_pred_rt = (
            exact_pred, bucket_pred)
        try:
            m, _ = frame_test.main([
                "--cfg", preset, "--dataroot", root, "--num_class", str(k),
                *(["--load", load] if load else []), "--width_bucket",
                str(bucket), "--is_save", "--saveroot", out, "--seed", "0",
                *opts])
        finally:
            frame_test.inference_pred, frame_test.inference_pred_rt = saved
        secs = time.perf_counter() - t0
        c = counts()
        if not tag:
            launches[path] = c
        d = os.path.join(out, "video_000")
        pngs = [np.asarray(Image.open(os.path.join(d, n)))
                for n in sorted(os.listdir(d))]
        print(f"{path}: per-frame eval ({label}, {hw[0]}x{hw[1]}"
              + (f", buckets {m['buckets']}" if bucket else "")
              + f", {n_frames} frames), host clock {1e3 * secs / n_frames:.1f}"
              f" ms/frame with model set-up; per frame (decode, forward, "
              f"argmax) {m['first_frame_ms']:.1f} ms for the first, then "
              f"{m['frame_ms']:.1f}; mIoU {m['mIoU']:.6f}; band_zero "
              f"{c['band_zero'] / n_frames:g} a frame (derived "
              f"{per_frame if bucket else 0}); kernel launches {c}")
        want = {"band_zero": per_frame * n_frames} if bucket else {}
        for kname, n in c.items():
            if not tag and n != want.get(kname, 0):
                raise SystemExit(f"{kname}: {n} launches on the {path} "
                                 f"path, expected {want.get(kname, 0)}")
        if bucket and m["buckets"] != [key]:
            raise SystemExit(f"{path} touched {m['buckets']}")
        if len(pngs) != n_frames or not np.isfinite(m["mIoU"]) or any(
                p.shape != hw or p.max() >= k for p in pngs):
            raise SystemExit(f"{path}: bad predictions or mIoU "
                             f"{m['mIoU']}")
        out_run = (captured[:], pngs, m)
        captured.clear()
        return out_run

    def check(exact, other):
        """(logit error, limit, PNG pixels that differ, excused)."""
        err = max((b - e).abs().max().item()
                  for e, b in zip(exact[0], other[0]))
        tol = 1e-3 * max(e.abs().max().item() for e in exact[0])
        diff = excused = 0
        for e, pe, pb in zip(exact[0], exact[1], other[1]):
            top = e.topk(2, dim=0).values
            near = (top[0] - top[1] < tol).cpu().numpy()
            differ = pe != pb
            diff += int(differ.sum())
            excused += int((differ & near).sum())
        return err, tol, diff, excused

    launches = {}
    exact, bucketed = run(0), run(64)
    err, tol, diff, excused = check(exact, bucketed)
    planted = None
    if fault is not None:
        with fault():
            faulty = run(64, tag="_planted")
        planted = check(exact, faulty)
        del faulty
    del exact, bucketed

    cfg = default_cfg.clone()
    cfg.merge_from_file(preset)
    cfg.merge_from_list(list(opts))
    model = frame_test.build_model(cfg, args, "cuda")
    x = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1))[None])
    x = x.cuda()
    reset()
    ms = {"exact_ms": cuda_ms(lambda: frame_test.frame_pred(model, x),
                              n=10, warm=3),
          "bucketed_ms": cuda_ms(lambda: frame_test.frame_pred(model, x, 64),
                                 n=10, warm=3)}
    with FlopCounterMode(display=False) as fc:
        frame_test.frame_pred(model, x)
    ms["gflop"] = fc.get_total_flops() / 1e9
    ms["mfu_exact"] = fc.get_total_flops() / (1e-3 * ms["exact_ms"]) / (
        PEAK_F32_FLOPS[torch.cuda.get_device_name(0)])
    reset()
    del model
    print(f"{name}, bucketed vs exact: logits on the valid region "
          f"max |diff| {err:.3e} (limit {tol:.3e}); PNGs differ at {diff} of "
          f"{n_frames * hw[0] * hw[1]} pixels, {excused} of them with an "
          f"exact top-2 margin below the limit; a frame's forward, upsample "
          f"and argmax (CUDA events, 10 calls): exact {ms['exact_ms']:.2f} "
          f"ms ({ms['gflop']:.1f} GFLOP counted, mfu "
          f"{ms['mfu_exact']:.4f}), bucketed in {key[0]}x{key[1]} "
          f"{ms['bucketed_ms']:.2f} ms; B6 "
          f"{per_frame} a frame (derived)"
          + ("" if planted is None else
             f"; the planted fault reads {planted[0]:.3e} (limit "
             f"{planted[1]:.3e}), PNGs differ at {planted[2]} pixels, "
             f"{planted[3]} excused"))
    if not (err <= tol and diff == excused):
        raise SystemExit(f"{name}: the bucketed eval disagrees with exact")
    out = {"logit_err": err, "logit_tol": tol, "pixels_differ": diff,
           "pixels_excused": excused, "band_zero_per_frame": per_frame, **ms}
    if planted is not None:
        if planted[0] <= planted[1] and planted[2] == planted[3]:
            raise SystemExit(f"{name}: the bucketed eval check missed the "
                             "planted fault")
        out.update(planted_fault_err=planted[0], planted_fault_caught=True)
    return launches, out


def frame_train_phase(torch, train_root, work, k, reset, counts,
                      preset=FRAME_PRESET, batch=8, trainfps=5, epochs=2,
                      watch=("encoder.conv1.weight",
                             "decoder.conv_last_.4.weight"), opts=(),
                      label=None):
    """g (and o). The per-frame trainer (``train``) with ``preset``
    (default the R101 ``ppm_deepsup`` one: batch 8, crop 479,
    ``--multi_scale True``, every third frame of the 4 videos, 16 frames,
    two steps an epoch, 2 epochs), 4 steps.  Losses finite, the ``watch``
    parameters (an encoder's and a head's) moved, no kernel launched;
    prints the steps' host time and the data wait.  ``opts``: trailing
    ``KEY VALUE`` overrides of the preset; ``label``: the run's name
    (default the preset's).  Returns (launches, numbers)."""
    from cvpr2021_vspw_implement_tpu_torch import train as frame_train

    records, before = [], {}
    step = frame_train.train_step

    def first_step(model, *args):
        if not before:
            named = dict(model.named_parameters())
            before.update({n: named[n].detach().clone() for n in watch})
        return step(model, *args)

    frame_train.train_step = first_step
    step_timer(frame_train, records)
    reset()
    torch.cuda.reset_peak_memory_stats()
    label = label or os.path.splitext(os.path.basename(preset))[0]
    try:
        model = frame_train.main([
            "--cfg", preset, "--dataroot", train_root, "--num_class",
            str(k), "--batchsize", str(batch), "--cropsize", "479",
            "--multi_scale", "True", "--trainfps", str(trainfps), "--lr",
            "0.002", "--totalepoch", str(epochs), "--validation", "False",
            "--saveroot", os.path.join(work, "ckpt_" + label), "--seed", "0",
            "DIR", os.path.join(work, "cfg_" + label), *opts])
    finally:
        frame_train.train_step = step
    c = counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [r[2] for r in records]
    times = [1e3 * (r[1] - r[0]) for r in records]
    waits = data_waits_ms(records, 4 // epochs)
    named = dict(model.named_parameters())
    if len(records) != 4 or not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"per-frame train ({label}): {len(records)} steps, "
                         f"losses {losses}")
    for n in watch:
        if torch.equal(named[n].detach(), before[n]):
            raise SystemExit(f"per-frame train ({label}): {n} did not move")
    if any(c.values()):
        raise SystemExit(f"per-frame train ({label}) launched a kernel: {c}")
    print(f"train frame ({label}, batch {batch}, crop 479, multi_scale, "
          f"f32): first step {times[0]:.1f} ms, then "
          f"{sum(times[1:]) / 3:.1f} ms/step over 3 steps (host clock, "
          f"synchronised); data wait inside an epoch "
          f"{[round(w, 1) for w in waits]} ms; losses "
          f"{[round(v, 4) for v in losses]}; peak memory "
          f"{peak / 2 ** 30:.2f} GiB; kernel launches {c}")
    return c, {"step_ms": times, "data_wait_ms": waits, "losses": losses,
               "peak_gib": peak / 2 ** 30}


def loader_comparison():
    """``tools/torch_loader_bench.py``: clip_psp's and propnet's steps with
    the serial walk and with the prefetch loader, 6 steps a run."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_loader_bench

    result = torch_loader_bench.run(("clip_psp", "propnet"), steps=6)
    out = torch_loader_bench.summary(result)
    print(f"loader, serial vs prefetched (mean ms over 2 runs x 5 steps): "
          f"{json.dumps(out)}")
    return out


#: the presets of phases h and i: TCB-OCR's (the reference's
#: run_temporal_ocr.sh) and, for NetWarp, the clip preset of the other
#: clip phases
OCR_NETWARP_PRESETS = {
    name: os.path.join(REPO, "cvpr2021_vspw_implement_tpu_torch", "config",
                       "presets", f"vsp-resnet101dilated-{name}.yaml")
    for name in ("ocr_deepsup", "ppm_deepsup_clip")}
#: the TCB-OCR and NetWarp eval phases: (path, --method, flags, preset
#: name); clip_ocr streams windows, clip_ocr_memory takes the window path
#: with the ring of contexts (the run script's eval), netwarp and
#: netwarp_ocr stream pairs
OCR_NETWARP_EVAL_PATHS = (
    ("clip_ocr", "clip_ocr", [], "ocr_deepsup"),
    ("clip_ocr_memory", "clip_ocr", ["--use_memory", "True"], "ocr_deepsup"),
    ("netwarp", "netwarp", ["--clip_num", "2"], "ppm_deepsup_clip"),
    ("netwarp_ocr", "netwarp_ocr", ["--clip_num", "2"], "ocr_deepsup"),
)
#: the RAFT methods' eval: B1 once and B4 twice a refinement, 20 a pair
NETWARP_RAFT_ITERS = 20


def ocr_netwarp_band_launches(torch, raft, arch="resnet101dilated"):
    """B6's launches in a bucketed frame (a window for clip_ocr_memory) of
    each path of OCR_NETWARP_EVAL_PATHS, from the models, where every map
    has a band (480x853 in 480x896).  TCB-OCR: the input of every spatial
    conv of the trunk and of the two heads' 3x3 convs (one masked call for
    all of a window's frames), the stem max pool and the OCR features.
    NetWarp a frame: its encode (the trunk's, the four levels, the
    decoder's C5 or OCR features) and its pair (the two images, ``raft``'s
    count of a TC pair, the flow, FlowCNN's spatial convs and its output,
    the decoder's, the blended features)."""
    from cvpr2021_vspw_implement_tpu_torch.models.netwarp import FlowCNN
    from cvpr2021_vspw_implement_tpu_torch.models.resnet import build_encoder

    def spatial_convs(module):
        return sum(isinstance(m, torch.nn.Conv2d) and max(m.kernel_size) > 1
                   for m in module.modules())

    trunk = spatial_convs(build_encoder(arch))
    per_pair = band_zero_launches(torch, raft)[1]
    netwarp = (trunk + 6) + (per_pair + spatial_convs(FlowCNN()) + 6)
    return {"clip_ocr": trunk + 4, "clip_ocr_memory": trunk + 4,
            "netwarp": netwarp, "netwarp_ocr": netwarp}


def scale_flow_head(torch, raft, factor=0.1):
    """Scale RAFT's flow head (its last conv) by ``factor``: at 0.1 a
    trained-like step (the random init moves the flow ~20 px a refinement,
    and each refinement then amplifies f32 rounding ~8x).  Returns
    ``raft``."""
    with torch.no_grad():
        raft.update_block.flow_head.conv2.weight.mul_(factor)
        raft.update_block.flow_head.conv2.bias.mul_(factor)
    return raft


def live_netwarp_blend(torch, model, seed=0):
    """Set NetWarp's blend weights (w0_0, w0_1, w1_0, w1_1) to seeded values
    in [0.3, 0.7].  At init they are (1, 0), and a prediction then does not
    read the warped features; with these, every comparison of predictions
    holds the feature warp too.  Returns ``model``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name in ("w0_0", "w0_1", "w1_0", "w1_1"):
            p = getattr(model, name)
            p.copy_(0.3 + 0.4 * torch.rand(p.shape, generator=g))
    return model


def live_nonlocal_scale(torch, model, seed=0, stats=True):
    """Give the non-local block's residual BatchNorm (``W_z.1``) seeded
    scale in [0.5, 1.5] and bias, and with ``stats`` seeded running
    statistics; ``model`` is a ``NonLocal3D`` or the block itself.  At init
    its scale is 0 and the block is the identity: a prediction then does
    not read the attention.  Returns ``model``."""
    g = torch.Generator().manual_seed(seed)
    bn = getattr(model, "nonlocalblock", model).W_z[1]
    n = bn.num_features
    with torch.no_grad():
        bn.weight.copy_(0.5 + torch.rand(n, generator=g))
        bn.bias.copy_(0.1 * torch.randn(n, generator=g))
        if stats:
            bn.running_mean.copy_(0.1 * torch.randn(n, generator=g))
            bn.running_var.copy_(0.5 + torch.rand(n, generator=g))
    return model


def calibrate_batchnorm(torch, model, *inputs):
    """Set every BatchNorm's running statistics to those of one training
    forward of ``model`` on ``inputs`` (no gradient), as training leaves
    them; returns ``model`` in eval mode.  At the seeded init they are the
    identity, and the R101 trunk's C5 then reaches ~1e5: the non-local
    block's product of three projections of it gives logits of ~1e18 and a
    prediction of one class.  Calibrated, every map is of unit scale."""
    bns = [m for m in model.modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    saved = [bn.momentum for bn in bns]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None            # a cumulative average: this batch's
    try:
        with torch.no_grad():
            model.train()(*inputs)
    finally:
        for bn, momentum in zip(bns, saved):
            bn.momentum = momentum
    return model.eval()


def live_td4_weights(torch, model, seed=0, qk_scale=0.1):
    """Give TDNet's four spatial LayerNorms seeded affine maps (scale in
    [0.5, 1.5], bias N(0, 0.1)), and scale the last conv of every query and
    key projection by ``qk_scale``.  At init the maps are ones and zeros,
    and a resize of them, exact or bucketed, is the same constant: with
    these the comparisons hold the maps' resize too.  At the seeded init the
    attention logits reach ~1e3, a one-hot softmax that turns f32 rounding
    into 1e-4 of the logits; at 0.1 a side they are a few units.  Returns
    ``model``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for i in range(1, 5):
            ln = getattr(model, f"layer_norm{i}").ln
            ln.weight.copy_(0.5 + torch.rand(ln.weight.shape, generator=g))
            ln.bias.copy_(0.1 * torch.randn(ln.bias.shape, generator=g))
            enc = getattr(model, f"enc{i}")
            for proj in (enc.w_qs, enc.w_ks):
                proj[1].conv.weight.mul_(qk_scale)
                proj[1].conv.bias.mul_(qk_scale)
    return model


def capture_stream_logits(serving, captured):
    """Wrap the streaming engines' prediction heads (``serving``'s
    ``inference_pred`` and ``inference_pred_rt``) so that each frame's
    logits are kept in ``captured`` as :func:`capture_window_logits` keeps
    a window's (no near-tie positions).  Returns what
    :func:`restore_stream_heads` puts back."""
    saved = serving.inference_pred, serving.inference_pred_rt

    def exact(logits, size, *args, **kw):
        captured.append((logits.detach().clone(), size, None))
        return saved[0](logits, size, *args, **kw)

    def bucketed(logits, pad, fv, hw, *args, **kw):
        captured.append((logits.detach().clone(), pad, fv, hw, None))
        return saved[1](logits, pad, fv, hw, *args, **kw)

    serving.inference_pred, serving.inference_pred_rt = exact, bucketed
    return saved


def restore_stream_heads(serving, saved):
    serving.inference_pred, serving.inference_pred_rt = saved


@contextlib.contextmanager
def raft_iters(raft, iters):
    saved, raft.iters = raft.iters, iters
    try:
        yield raft
    finally:
        raft.iters = saved


def netwarp_flow_check(torch, model, frames):
    """NetWarp's flows bucketed in 480x896 against exact on the video's
    pairs, after RAFT's first refinement (with random weights each
    refinement amplifies rounding, see :func:`tc_flow_check`), ``model``'s
    RAFT with the TC phases' flow head (:func:`scale_flow_head`): RAFT's
    flow (``NetWarp._raft_flow``, through ``bucketed_flow``) held to TC's
    ``TC_FLOW_LIMIT_PX``, and the refined flow (``NetWarp._flow``, FlowCNN
    under the mask) to the larger of that and 1e-4 of the largest exact
    refined flow (the random FlowCNN scales the flow, to about 130 px, and
    sums its 0-255 images into it).  A planted fault, FlowCNN run without
    its mask (so its 3x3 convs read the band), must exceed the second
    limit.  Printed, not held: the two gaps with the flow head at the
    seeded init's scale (x10), where the first refinement's step, and with
    it the gap of rounding, is 10x larger.  Returns the readings."""
    from cvpr2021_vspw_implement_tpu_torch.models import netwarp as nw
    from cvpr2021_vspw_implement_tpu_torch.ops.masked import bucket_hw, pad_to

    h, w = frames[0].shape[-2:]
    key = bucket_hw(h, w)

    def gap(planted=False):
        saved = nw.masked_trunk
        if planted:
            nw.masked_trunk = lambda *a, **kw: contextlib.nullcontext()
        raft_worst, worst, scale = 0.0, 0.0, 0.0
        try:
            with torch.inference_mode():
                for prev, target in zip(frames, frames[1:]):
                    padded = pad_to(target, key), pad_to(prev, key)
                    if not planted:
                        exact = model._raft_flow(target, prev)[2]
                        bucketed = model._raft_flow(*padded,
                                                    valid_hw=(h, w))[2]
                        raft_worst = max(raft_worst, (
                            bucketed[..., :h, :w] - exact).abs().max().item())
                    exact = model._flow(target, prev)
                    bucketed = model._flow(*padded, valid_hw=(h, w))
                    worst = max(worst, (bucketed[..., :h, :w] - exact)
                                .abs().max().item())
                    scale = max(scale, exact.abs().max().item())
        finally:
            nw.masked_trunk = saved
        return raft_worst, worst, scale

    with raft_iters(model.raft, 1):
        (raft_gap, sound, scale), (_, planted, _) = gap(), gap(planted=True)
        head = model.raft.update_block.flow_head.conv2
        saved = head.weight.detach().clone(), head.bias.detach().clone()
        scale_flow_head(torch, model.raft, 10.0)
        try:
            raft_gap10, sound10, _ = gap()
        finally:
            with torch.no_grad():
                head.weight.copy_(saved[0])
                head.bias.copy_(saved[1])
    limit = max(TC_FLOW_LIMIT_PX, 1e-4 * scale)
    print(f"NetWarp flow check, bucketed vs exact over {len(frames) - 1} "
          f"pairs after the first refinement: RAFT's flow largest |diff| "
          f"{raft_gap:.3e} px (limit {TC_FLOW_LIMIT_PX:g} px); the refined "
          f"flow {sound:.3e} px, with FlowCNN unmasked (planted fault) "
          f"{planted:.3e} px (limit {limit:.3e}: the larger of "
          f"{TC_FLOW_LIMIT_PX:g} px and 1e-4 of the largest refined flow, "
          f"{scale:.3e} px); not held, the flow head at the seeded init's "
          f"scale: RAFT's flow {raft_gap10:.3e} px, the refined flow "
          f"{sound10:.3e} px")
    if not raft_gap <= TC_FLOW_LIMIT_PX:
        raise SystemExit("NetWarp's bucketed RAFT flow disagrees with the "
                         "exact flow")
    if not (sound <= limit and scale > 0):
        raise SystemExit("NetWarp's bucketed flow disagrees with the exact "
                         "flow")
    if not planted > limit:
        raise SystemExit("the NetWarp flow check missed the planted fault")
    return {"raft_max_abs_px": raft_gap, "max_abs_px": sound,
            "planted_max_abs_px": planted, "limit_px": limit,
            "largest_flow_px": scale,
            "seeded_head_raft_max_abs_px": raft_gap10,
            "seeded_head_max_abs_px": sound10}


#: the refinements at which phase h holds NetWarp's bucketed predictions
#: against exact (RAFT's 20 amplify rounding to tens of px with random
#: weights, see :func:`tc_flow_check`); its 20-refinement runs are timed and
#: their launches held
NETWARP_HELD_ITERS = 1


def live_netwarp_checkpoints(torch, test_clip, work, k):
    """{method: path} of a ``state_dict`` of the seeded R101 ``netwarp`` and
    ``netwarp_ocr`` (``--seed 0``) with live blend weights
    (:func:`live_netwarp_blend`) and the TC phases' trained-like RAFT flow
    head (:func:`scale_flow_head`), for the eval phases' ``--load``."""
    from cvpr2021_vspw_implement_tpu_torch.config import cfg as default_cfg

    out = {}
    for path, method, flags, preset in OCR_NETWARP_EVAL_PATHS:
        if not method.startswith("netwarp"):
            continue
        args = test_clip.build_eval_clip_parser().parse_args(
            ["--cfg", OCR_NETWARP_PRESETS[preset], "--num_class", str(k),
             "--method", method, *flags, "--seed", "0"])
        cfg = default_cfg.clone()
        cfg.merge_from_file(OCR_NETWARP_PRESETS[preset])
        model = live_netwarp_blend(torch, test_clip.build_model(cfg, args,
                                                                "cpu"))
        scale_flow_head(torch, model.raft)
        out[method] = os.path.join(work, f"{method}_live_blend.pth")
        torch.save(model.state_dict(), out[method])
    return out


def ocr_netwarp_eval_phases(torch, test_clip, root, work, k, n_frames,
                            reset, counts, raft, check_pngs, pngs):
    """h. The TCB-OCR and NetWarp eval CLIs over the 10-frame 480x853 video
    with seeded random R101 models (NetWarp's with live blend weights,
    :func:`live_netwarp_checkpoints`), each path of OCR_NETWARP_EVAL_PATHS
    at exact shapes (``--width_bucket 0``) then at the CLI's default,
    bucketed in 480x896: B6 at its derived count a frame (a window), B1 and
    B4 at 20 and 40 a pair on the NetWarp paths, no other launch; PNGs and
    finite mIoU and VC; each bucketed run held against its exact run as the
    window phases are (:func:`window_bucket_check`).  The NetWarp paths are
    held so in a second exact and bucketed pair of runs with RAFT at
    ``NETWARP_HELD_ITERS`` refinements (B1 and B4 held at 1 and 2 a pair),
    and a planted fault there, the bucketed feature warps normalised by the
    padded size instead of the true one, must fail the check; then
    NetWarp's flow check.  Returns (launches by path, checks by path)."""
    import numpy as np

    from cvpr2021_vspw_implement_tpu_torch import serving
    from cvpr2021_vspw_implement_tpu_torch.config import cfg as default_cfg
    from cvpr2021_vspw_implement_tpu_torch.data import TestFrameDataset
    from cvpr2021_vspw_implement_tpu_torch.models import netwarp as nw

    presets = OCR_NETWARP_PRESETS
    per_unit = ocr_netwarp_band_launches(torch, raft)
    with raft_iters(raft, NETWARP_HELD_ITERS):
        per_unit_held = ocr_netwarp_band_launches(torch, raft)
    ckpts = live_netwarp_checkpoints(torch, test_clip, work, k)
    launches, checks = {}, {}

    def run(path, method, flags, preset, bucket, iters, tag=""):
        """One CLI run → (captured logits, PNGs, metrics), its launches
        held (kept in ``launches`` unless ``tag`` names a planted run)."""
        name = path + tag + ("_bucketed" if bucket else "")
        out_dir = os.path.join(work, "preds_" + name)
        captured = []
        saved_w = capture_window_logits(test_clip, captured)
        saved_s = capture_stream_logits(serving, captured)
        load = ["--load", ckpts[method]] if method in ckpts else []
        opts = (["TPU.raft_iters", str(iters)]
                if iters != NETWARP_RAFT_ITERS else [])
        reset()
        t0 = time.perf_counter()
        try:
            m, _ = test_clip.main([
                "--cfg", presets[preset], "--dataroot", root,
                "--num_class", str(k), "--method", method, *flags, *load,
                "--width_bucket", str(bucket), "--is_save", "--saveroot",
                out_dir, "--seed", "0", *opts])
        finally:
            restore_window_heads(test_clip, saved_w)
            restore_stream_heads(serving, saved_s)
        secs = time.perf_counter() - t0
        c = counts()
        if tag != "_planted":
            launches[name] = c
        amortized = (m["first_frame_ms"]
                     + (n_frames - 1) * m["frame_ms"]) / n_frames
        print(f"{name} eval (R101, 480x853"
              + (" in the 480x896 bucket" if bucket else "")
              + f", {n_frames} frames"
              + (f", RAFT {iters} refinements"
                 if method.startswith("netwarp") else "")
              + f"), host clock: {1e3 * secs / n_frames:.1f} ms/frame with "
              f"model set-up; evaluate_clip's frame times (decode, forward, "
              f"argmax) {m['first_frame_ms']:.1f} ms for the first, then "
              f"{m['frame_ms']:.1f} ms, {amortized:.1f} ms a frame over the "
              f"video; mIoU {m['mIoU']:.6f} VC {m['VC']:.6f}; kernel "
              f"launches {c}")
        units = per_unit if iters == NETWARP_RAFT_ITERS else per_unit_held
        want = {"band_zero": units[path] * n_frames if bucket else 0}
        if method.startswith("netwarp"):
            want.update(corr_lookup=iters * n_frames,
                        sep_gru=2 * iters * n_frames)
        for kname, n in c.items():
            if n != want.get(kname, 0):
                raise SystemExit(f"{kname}: {n} launches on the {name} "
                                 f"path, expected {want.get(kname, 0)}")
        check_pngs(os.path.join(out_dir, "video_000"), n_frames)
        if not (np.isfinite(m["mIoU"]) and np.isfinite(m["VC"])):
            raise SystemExit(f"{name}: non-finite metric")
        return captured, pngs(out_dir), m

    for path, method, flags, preset in OCR_NETWARP_EVAL_PATHS:
        runs = {b: run(path, method, flags, preset, b, NETWARP_RAFT_ITERS)
                for b in (0, 64)}
        timed = {"band_zero_per_frame": per_unit[path],
                 "ms_a_frame_host": {
                     b: (r[2]["first_frame_ms"] + (n_frames - 1)
                         * r[2]["frame_ms"]) / n_frames
                     for b, r in (("exact", runs[0]), ("bucketed", runs[64]))}}
        if not method.startswith("netwarp"):
            checks[path] = window_bucket_check(
                torch, path, runs[0][0], runs[64][0], runs[0][1], runs[64][1])
            checks[path].update(timed)
            del runs
            continue
        moved = sum(int((a != b).sum()) for a, b in zip(runs[0][1],
                                                        runs[64][1]))
        print(f"{path} at RAFT {NETWARP_RAFT_ITERS} refinements (not held): "
              f"bucketed PNGs differ from exact at {moved} of "
              f"{n_frames * runs[0][1][0].size} pixels")
        del runs
        held = {b: run(path, method, flags, preset, b, NETWARP_HELD_ITERS,
                       tag=f"_raft{NETWARP_HELD_ITERS}") for b in (0, 64)}
        checks[path] = window_bucket_check(
            torch, f"{path} (RAFT {NETWARP_HELD_ITERS} refinement)",
            held[0][0], held[64][0], held[0][1], held[64][1])
        checks[path].update(timed, raft_iters_held=NETWARP_HELD_ITERS,
                            pixels_differ_at_20_not_held=moved)
        if path == "netwarp":
            plain_warp = nw.flowwarp
            nw.flowwarp = lambda x, flow, valid_hw=None: plain_warp(x, flow)
            try:
                planted = run(path, method, flags, preset, 64,
                              NETWARP_HELD_ITERS, tag="_planted")
            finally:
                nw.flowwarp = plain_warp
            try:
                window_bucket_check(torch, f"{path} (planted fault)",
                                    held[0][0], planted[0], held[0][1],
                                    planted[1])
            except SystemExit:
                checks[path]["planted_fault_caught"] = True
            else:
                raise SystemExit("the NetWarp bucketed eval check missed the "
                                 "planted fault (warps normalised by the "
                                 "padded size)")
            del planted
        del held

    args = test_clip.build_eval_clip_parser().parse_args(
        ["--cfg", presets["ppm_deepsup_clip"], "--num_class", str(k),
         "--method", "netwarp", "--clip_num", "2", "--load",
         ckpts["netwarp"]])
    cfg = default_cfg.clone()
    cfg.merge_from_file(presets["ppm_deepsup_clip"])
    model = test_clip.build_model(cfg, args, "cuda")
    ds = TestFrameDataset(root, "video_000", args)
    frames = [torch.from_numpy(ds[i][0]).cuda().permute(2, 0, 1)[None]
              .contiguous() for i in range(len(ds))]
    reset()
    checks["netwarp_flow"] = netwarp_flow_check(torch, model, frames)
    reset()
    del model, frames
    return launches, checks


#: the TCB-OCR and NetWarp train phases: (--method, flags, preset name)
OCR_NETWARP_TRAIN_PATHS = (
    ("clip_ocr", ["--clip_num", "4", "--dilation2", "3,6,9"],
     "ocr_deepsup"),
    ("netwarp", ["--clip_num", "2", "--dilation_num", "0"],
     "ppm_deepsup_clip"),
    ("netwarp_ocr", ["--clip_num", "2", "--dilation_num", "0"],
     "ocr_deepsup"),
    ("etc_ocr", ["--clip_num", "2", "--dilation_num", "0", "--st_weight",
                 "0.1"], "ocr_deepsup"),
)


def ocr_netwarp_train_phases(torch, train_root, work, k, steps, reset,
                             counts):
    """i. ``train_clip`` for each of OCR_NETWARP_TRAIN_PATHS at crop 479,
    batch 2, ``steps`` steps (:func:`train_phase`: finite losses, a head
    and an encoder parameter moved, RAFT not): B1, B2 and B3 at 20 a step
    on the RAFT methods (their 2x60x60 features are under B4's gate, so
    the update block takes the fused route), nothing else.  Returns the
    launches by path."""
    presets = OCR_NETWARP_PRESETS
    launches = {}
    for method, flags, preset in OCR_NETWARP_TRAIN_PATHS:
        reset()
        train_phase(torch, method, flags, train_root, work, presets[preset],
                    k, steps)
        launches["train_" + method] = c = counts()
        want = ({} if method == "clip_ocr" else
                {n: NETWARP_RAFT_ITERS * steps for n in (
                    "corr_lookup", "motion_encoder", "gru_flowhead")})
        print(f"kernel launches in the {method} train phase {c}")
        for kname, n in c.items():
            if n != want.get(kname, 0):
                raise SystemExit(f"{kname}: {n} launches on the {method} "
                                 f"train path, expected {want.get(kname, 0)}")
    return launches


def tdnet_band_launches(torch):
    """B6's launches in a bucketed TDNet frame, from the model: its path's
    masked trunk (the input of every spatial conv of ResNet-18-dilated, the
    stem max pool), C5, the attended features and the LayerNorm's two
    (the input's band, the deviations')."""
    from cvpr2021_vspw_implement_tpu_torch.models.resnet import build_encoder

    return sum(isinstance(m, torch.nn.Conv2d) and max(m.kernel_size) > 1
               for m in build_encoder("resnet18dilated").modules()) + 1 + 4


def nonlocal3d_band_launches(torch, arch="resnet101dilated"):
    """B6's launches in a bucketed Non-local 3D window, from the model: the
    masked trunk (one call for all of the window's frames: the input of
    every spatial conv, the stem max pool) and the embedding."""
    from cvpr2021_vspw_implement_tpu_torch.models.resnet import build_encoder

    return sum(isinstance(m, torch.nn.Conv2d) and max(m.kernel_size) > 1
               for m in build_encoder(arch).modules()) + 1 + 1


#: TDNet's eval phase streams this many frames (every pos_id warm from the
#: fourth on, each path three times warm)
TDNET_FRAMES = 12
TDNET_PRESET = os.path.join(
    REPO, "cvpr2021_vspw_implement_tpu_torch", "config", "presets",
    "vsp-resnet18dilated-ppm_deepsup_clip.yaml")
NONLOCAL3D_CLIP_NUM = 3


def capture_probs_logits(test_clip, captured, margins):
    """Wrap ``test_clip``'s probability heads (``inference_probs``,
    ``inference_probs_rt``) so that the logits of each frame of each window
    are kept in ``captured`` as :func:`capture_window_logits` keeps them,
    and ``frame_pred`` so that each flushed frame's top-2 margin of its
    averaged probabilities is kept in ``margins``, in flush order.  Returns
    what :func:`restore_probs_heads` puts back."""
    saved = (test_clip.inference_probs, test_clip.inference_probs_rt,
             test_clip.frame_pred)

    def exact(logits, size):
        captured.append((logits.detach().clone(), size, None))
        return saved[0](logits, size)

    def bucketed(logits, pad, fv, hw):
        captured.append((logits.detach().clone(), pad, fv, hw, None))
        return saved[1](logits, pad, fv, hw)

    def frame_pred(acc, n):
        top = (acc / n).topk(2, dim=1).values[0]
        margins.append(top[0] - top[1])
        return saved[2](acc, n)

    (test_clip.inference_probs, test_clip.inference_probs_rt,
     test_clip.frame_pred) = exact, bucketed, frame_pred
    return saved


def restore_probs_heads(test_clip, saved):
    (test_clip.inference_probs, test_clip.inference_probs_rt,
     test_clip.frame_pred) = saved


def nonlocal3d_bucket_check(torch, path, exact, bucketed, margins, order,
                            exact_pngs, bucket_pngs):
    """Non-local 3D's ``test_all`` bucketed against exact: every frame's
    upsampled logits of every window on the valid region within 1e-3 of the
    largest exact logit, and the PNGs equal but at pixels whose exact
    averaged probabilities' top-2 margin is below 1e-3 (``margins`` in
    flush order ``order``, the frames' indices)."""
    from cvpr2021_vspw_implement_tpu_torch.ops.interpolate import \
        resize_bilinear
    from cvpr2021_vspw_implement_tpu_torch.ops.masked import \
        resize_bilinear_rt

    if len(exact) != len(bucketed) or len(margins) != len(exact_pngs):
        raise SystemExit(f"{path}: captured {len(exact)} exact and "
                         f"{len(bucketed)} bucketed frames, {len(margins)} "
                         f"flushes for {len(exact_pngs)} frames")
    err = scale = 0.0
    for (le, size, _), (lb, pad, fv, (h, w), _) in zip(exact, bucketed):
        e = resize_bilinear(le.float(), size)[0]
        b = resize_bilinear_rt(lb.float(), pad, fv, (h, w))[0, :, :h, :w]
        err = max(err, (b - e).abs().max().item())
        scale = max(scale, e.abs().max().item())
    tol = 1e-3 * scale
    diff = excused = 0
    for i, margin in zip(order, margins):
        differ = exact_pngs[i] != bucket_pngs[i]
        diff += int(differ.sum())
        excused += int((differ & (margin < 1e-3).cpu().numpy()).sum())
    print(f"{path} bucketed vs exact test_all: logits of {len(exact)} window "
          f"frames on the valid region max |diff| {err:.3e} (limit "
          f"{tol:.3e}, 1e-3 of the largest exact logit); PNGs differ at "
          f"{diff} of {len(exact_pngs) * exact_pngs[0].size} pixels, "
          f"{excused} of them excused (averaged probabilities' top-2 margin "
          f"below 1e-3)")
    if not (err <= tol and diff == excused):
        raise SystemExit(f"{path}: bucketed test_all disagrees with exact")
    return {"logit_err": err, "logit_tol": tol, "pixels_differ": diff,
            "pixels_excused": excused}


def tdnet_nonlocal3d_eval_phases(torch, test_clip, root, td_root, work, k,
                                 n_frames, reset, counts, check_pngs, pngs):
    """j. ``test_clip --method tdnet`` over a TDNET_FRAMES-frame 480x853
    video (seeded four ResNet-18-dilated paths at crop 479, the LayerNorm
    maps live and the attention's logits a few units,
    :func:`live_td4_weights`), exact then bucketed in 480x896: B6 at
    :func:`tdnet_band_launches` a frame, none exact; each frame's logits
    held as the window phases hold them (:func:`window_bucket_check`, the
    upsampling ``align_corners=True``); a planted fault, the token mask off
    in the bucketed attention, must fail that check.
    k. ``test_clip --method nonlocal3d --clip_num 3`` (``test_all``, seeded
    R101, its BatchNorm statistics those of the video's first window
    (:func:`calibrate_batchnorm`) and the block's residual scale live,
    :func:`live_nonlocal_scale`)
    over the 10-frame video, exact then bucketed: B6 at
    :func:`nonlocal3d_band_launches` a window; held by
    :func:`nonlocal3d_bucket_check`; a planted fault, the dot normaliser
    counting the padded positions, must fail it.  Returns (launches by
    path, checks by path)."""
    import numpy as np

    from cvpr2021_vspw_implement_tpu_torch import serving
    from cvpr2021_vspw_implement_tpu_torch.config import cfg as default_cfg
    from cvpr2021_vspw_implement_tpu_torch.data import TestClipDataset
    from cvpr2021_vspw_implement_tpu_torch.models import (nonlocal_blocks,
                                                          td4_psp)

    launches, checks = {}, {}
    per_td, per_nl = tdnet_band_launches(torch), nonlocal3d_band_launches(
        torch)
    presets = {"tdnet": TDNET_PRESET,
               "nonlocal3d": OCR_NETWARP_PRESETS["ppm_deepsup_clip"]}
    flags = {"tdnet": [], "nonlocal3d": ["--clip_num",
                                         str(NONLOCAL3D_CLIP_NUM)]}
    ckpts = {}
    for method in ("tdnet", "nonlocal3d"):
        args = test_clip.build_eval_clip_parser().parse_args(
            ["--cfg", presets[method], "--num_class", str(k), "--method",
             method, *flags[method], "--seed", "0"])
        cfg = default_cfg.clone()
        cfg.merge_from_file(presets[method])
        model = test_clip.build_model(cfg, args, "cuda")
        if method == "tdnet":
            live_td4_weights(torch, model.cpu())
        else:
            # the statistics of the video's first window, then the live
            # residual scale on them
            ds = TestClipDataset(root, "video_000", args)
            window = torch.from_numpy(np.stack(ds[0][2])[:, None]).cuda()
            calibrate_batchnorm(torch, model, window.permute(
                0, 1, 4, 2, 3).contiguous())
            live_nonlocal_scale(torch, model, stats=False)
            del ds, window
        ckpts[method] = os.path.join(work, f"{method}_live.pth")
        torch.save(model.state_dict(), ckpts[method])
        del model

    def run(method, bucket, tag=""):
        """One CLI run → (captured logits, margins, flush order, PNGs,
        metrics); its launches held (and kept unless ``tag``)."""
        data, n = (td_root, TDNET_FRAMES) if method == "tdnet" else (
            root, n_frames)
        name = method + tag + ("_bucketed" if bucket else "")
        out_dir = os.path.join(work, "preds_" + name)
        captured, margins, order = [], [], []
        saved_s = capture_stream_logits(serving, captured)
        saved_p = capture_probs_logits(test_clip, captured, margins)
        test_all = test_clip._test_all

        def ordered(*a, **kw):
            for item in test_all(*a, **kw):
                order.append(item[0])
                yield item
        test_clip._test_all = ordered
        reset()
        t0 = time.perf_counter()
        try:
            m, _ = test_clip.main([
                "--cfg", presets[method], "--dataroot", data, "--num_class",
                str(k), "--method", method, *flags[method], "--load",
                ckpts[method], "--width_bucket", str(bucket), "--is_save",
                "--saveroot", out_dir, "--seed", "0"])
        finally:
            restore_stream_heads(serving, saved_s)
            restore_probs_heads(test_clip, saved_p)
            test_clip._test_all = test_all
        secs = time.perf_counter() - t0
        c = counts()
        if not tag:
            launches[name] = c
        # one frame streamed, or one window, for each frame of the video
        per, unit, model = ((per_td, "frame", "four R18 paths")
                            if method == "tdnet" else
                            (per_nl, "window", "R101, clip_num 3, test_all"))
        amortized = (m["first_frame_ms"] + (n - 1) * m["frame_ms"]) / n
        print(f"{name} eval ({model}, 480x853"
              + (" in the 480x896 bucket" if bucket else "")
              + f", {n} frames), host clock: {1e3 * secs / n:.1f} ms/frame "
              f"with model set-up; evaluate_clip's frame times "
              f"{m['first_frame_ms']:.1f} ms for the first, then "
              f"{m['frame_ms']:.1f} ms, {amortized:.1f} ms a frame over the "
              f"video; band_zero {c['band_zero'] / n:g} a {unit} (derived "
              f"{per if bucket else 0}); mIoU {m['mIoU']:.6f} VC "
              f"{m['VC']:.6f}; kernel launches {c}")
        if not tag:
            want = per * n if bucket else 0
            for kname, got in c.items():
                if got != (want if kname == "band_zero" else 0):
                    raise SystemExit(f"{kname}: {got} launches on the {name} "
                                     f"path")
        check_pngs(os.path.join(out_dir, "video_000"), n)
        if not (np.isfinite(m["mIoU"]) and np.isfinite(m["VC"])):
            raise SystemExit(f"{name}: non-finite metric")
        return captured, margins, order, pngs(out_dir), m

    for method in ("tdnet", "nonlocal3d"):
        runs = {b: run(method, b) for b in (0, 64)}

        def check(exact, other, label):
            if method == "tdnet":
                return window_bucket_check(torch, label, exact[0], other[0],
                                           exact[3], other[3],
                                           align_corners=True)
            return nonlocal3d_bucket_check(torch, label, exact[0], other[0],
                                           exact[1], exact[2], exact[3],
                                           other[3])

        checks[method] = check(runs[0], runs[64], method)
        n = TDNET_FRAMES if method == "tdnet" else n_frames
        checks[method].update(
            band_zero_per_unit=per_td if method == "tdnet" else per_nl,
            ms_a_frame_host={
                b: (r[4]["first_frame_ms"] + (n - 1) * r[4]["frame_ms"]) / n
                for b, r in (("exact", runs[0]), ("bucketed", runs[64]))})
        if method == "tdnet":
            saved = td4_psp.token_valid
            td4_psp.token_valid = lambda *a: None
        else:
            saved = nonlocal_blocks.true_positions
            nonlocal_blocks.true_positions = (
                lambda spatial, valid_hw: math.prod(spatial))
        try:
            planted = run(method, 64, tag="_planted")
        finally:
            if method == "tdnet":
                td4_psp.token_valid = saved
            else:
                nonlocal_blocks.true_positions = saved
        try:
            check(runs[0], planted, f"{method} (planted fault)")
        except SystemExit:
            checks[method]["planted_fault_caught"] = True
        else:
            raise SystemExit(f"the {method} bucketed eval check missed the "
                             "planted fault")
        del runs, planted
    return launches, checks


#: the TDNet and Non-local 3D train phases: (--method, flags, a parameter
#: that must move, an encoder parameter that must move)
TDNET_NONLOCAL3D_TRAIN_PATHS = (
    ("tdnet", ["--clip_num", "4", "--dilation_num", "0"],
     "head2.conv5.4.weight", "pretrained1.conv1.weight", TDNET_PRESET),
    ("nonlocal3d", ["--clip_num", str(NONLOCAL3D_CLIP_NUM), "--dilation_num",
                    "0"], "nonlocalblock.W_z.1.weight",
     "encoder.conv1.weight", OCR_NETWARP_PRESETS["ppm_deepsup_clip"]),
)


def tdnet_nonlocal3d_train_phases(torch, train_root, work, k, steps, reset,
                                  counts):
    """l. ``train_clip --method tdnet`` (4 frames, four R18 paths) and
    ``--method nonlocal3d`` (3 frames, R101) at crop 479, batch 2,
    ``steps`` steps (:func:`train_phase`: finite losses, the named head and
    encoder parameters moved; TDNet's ``pos_id`` each step printed and
    held to the trainer's rotation); no kernel launches.  Returns the
    launches by path."""
    launches = {}
    for method, flags, head, encoder, preset in TDNET_NONLOCAL3D_TRAIN_PATHS:
        reset()
        train_phase(torch, method, flags, train_root, work, preset, k, steps,
                    head=head, encoder=encoder)
        launches["train_" + method] = c = counts()
        print(f"kernel launches in the {method} train phase {c}")
        if any(c.values()):
            raise SystemExit(f"the {method} train path launched a kernel")
    return launches


HRNET_PRESETS = {
    name: os.path.join(REPO, "cvpr2021_vspw_implement_tpu_torch", "config",
                       "presets", f"vsp-{name}.yaml")
    for name in ("hrnetv2", "hrnetv2_clip", "resnet101dilated-ocr_deepsup")}
HRNET_CLIP_NUM = 4
#: bucketed against exact, TimeAtten's blend weights (in [0, 1]): a sound
#: run differs by f32 rounding (6e-8 on the CPU at 480x853), the planted
#: fault by 4.5e-4
BLEND_WEIGHT_LIMIT = 1e-5


def hrnet_ocr_band_launches(torch):
    """B6's launches in bucketed eval, derived from the models: a
    per-frame HRNetV2 + C1 frame (the input of each spatial conv of the
    trunk, its one output level, C1's input), an ``hrnetv2_clip`` window
    (the same, the stem's spatial convs once more for the context frames,
    and TimeAtten's two re-zeros before its pooling) and a per-frame R101
    ``ocrnet_deepsup`` frame (:func:`frame_model_band_launches`)."""
    from cvpr2021_vspw_implement_tpu_torch.models.builder import ModelBuilder
    from cvpr2021_vspw_implement_tpu_torch.models.hrnet import HRNetV2
    from cvpr2021_vspw_implement_tpu_torch.models.segmentation import \
        SegmentationModule

    def spatial(*modules):
        return sum(isinstance(m, torch.nn.Conv2d) and max(m.kernel_size) > 1
                   for module in modules for m in module.modules())

    hrnet = HRNetV2()
    trunk, stem = spatial(hrnet), spatial(hrnet.conv1, hrnet.conv2,
                                          hrnet.layer1)
    with torch.device("meta"):
        ocrnet = frame_model_band_launches(torch, SegmentationModule(
            ModelBuilder.build_encoder("resnet101dilated"),
            ModelBuilder.build_decoder("ocrnet_deepsup", 2048)))
    return {"hrnet": trunk + 2, "hrnetv2_clip": trunk + stem + 4,
            "ocrnet": ocrnet}


def varied_video(root, out, gains=(1.0, 0.35, 1.6, 0.6, 1.25)):
    """A copy of ``root``'s first video whose frames differ: frame t's
    pixels times ``gains[t % 5]`` and its colour channels rolled by t.
    Over the synthetic video's near-identical frames TimeAtten's cosine
    weights are nearly uniform, and a fault in its pooling barely moves
    the blend; over these they spread.  Returns ``out``."""
    import shutil

    import numpy as np
    from PIL import Image

    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(root, out)
    vdir = os.path.join(out, "data", "video_000", "origin")
    for t, name in enumerate(sorted(os.listdir(vdir))):
        path = os.path.join(vdir, name)
        img = np.asarray(Image.open(path).convert("RGB"), np.float32)
        img = np.roll(img * gains[t % len(gains)], t, axis=-1)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            path, quality=90)
    return out


@contextlib.contextmanager
def patched(module, attr, value):
    """``module.attr`` set to ``value`` for the length of the context (a
    class's own attribute restored as it was, a ``staticmethod`` too)."""
    saved = vars(module)[attr]
    setattr(module, attr, value)
    try:
        yield
    finally:
        setattr(module, attr, saved)


def hrnet_ocr_phases(torch, test_clip, root, train_root, work, k, n_frames,
                     reset, counts, check_pngs, pngs):
    """m. The per-frame eval CLI ``test --cfg vsp-hrnetv2.yaml`` (seeded
    HRNetV2-W48 + C1, its BatchNorm statistics those of the video's first
    frame, :func:`calibrate_batchnorm`) over the 10-frame video, exact then
    bucketed (:func:`frame_eval_phase`); the planted fault, HRNet's fusion
    upsamples on the padded size (``resize_bilinear`` for
    ``resize_bilinear_rt``), must fail the check.
    n. ``test_clip --method hrnetv2_clip --clip_num 4`` (HRNetV2Clip + C1,
    its statistics those of the video's first window) over the video with
    its frames made to differ (:func:`varied_video`),
    exact then bucketed, each window's logits held as the window phases
    hold them (:func:`window_bucket_check`), and TimeAtten's blend weights
    within BLEND_WEIGHT_LIMIT of exact; the planted fault, TimeAtten
    pooling the padded grid with the stem's band in it, must fail them.
    The logits alone do not catch it at this size: the band is 10 of 224
    columns, the stem's band response nearly the same vector in every
    frame, and the fault moves a seeded model's logits by about 7e-4 of
    the largest (CPU, one window), inside the 1e-3 limit; it moves the
    weights by 4.5e-4, and a sound run by 6e-8.
    o. The per-frame trainer with ``vsp-hrnetv2.yaml`` and
    ``vsp-resnet101dilated-ocr_deepsup.yaml`` at crop 479, batch 2, 4
    steps each (:func:`frame_train_phase`); then the per-frame
    ``ocrnet_deepsup`` eval (seeded R101), exact and bucketed, held as m.
    B6 at :func:`hrnet_ocr_band_launches` a bucketed frame or window, none
    exact.  Returns (launches by path, checks by path)."""
    import numpy as np

    from cvpr2021_vspw_implement_tpu_torch import test as frame_test
    from cvpr2021_vspw_implement_tpu_torch.config import cfg as default_cfg
    from cvpr2021_vspw_implement_tpu_torch.data import (TestClipDataset,
                                                        TestFrameDataset)
    from cvpr2021_vspw_implement_tpu_torch.models import hrnet, hrnet_clip

    per = hrnet_ocr_band_launches(torch)
    launches, checks, ckpts = {}, {}, {}
    # n runs over frames that differ (:func:`varied_video`)
    clip_root = varied_video(root, os.path.join(work, "vspw_varied"))
    for name in ("hrnetv2", "hrnetv2_clip"):
        preset = HRNET_PRESETS[name]
        cfg = default_cfg.clone()
        cfg.merge_from_file(preset)
        if name == "hrnetv2":
            args = frame_test.build_eval_parser().parse_args(
                ["--cfg", preset, "--num_class", str(k), "--seed", "0"])
            model = frame_test.build_model(cfg, args, "cuda")
            x = TestFrameDataset(root, "video_000", args)[0][0]
            x = torch.from_numpy(np.ascontiguousarray(
                x.transpose(2, 0, 1))[None]).cuda()
        else:
            args = test_clip.build_eval_clip_parser().parse_args(
                ["--cfg", preset, "--num_class", str(k), "--method", name,
                 "--clip_num", str(HRNET_CLIP_NUM), "--seed", "0"])
            model = test_clip.build_model(cfg, args, "cuda")
            item = TestClipDataset(clip_root, "video_000", args)[0]
            x = torch.from_numpy(np.stack(item[2] + [item[0]])[:, None])
            x = x.permute(0, 1, 4, 2, 3).contiguous().cuda()
        calibrate_batchnorm(torch, model, x)
        ckpts[name] = os.path.join(work, f"{name}_live.pth")
        torch.save(model.state_dict(), ckpts[name])
        del model, x

    # m: per-frame HRNetV2 + C1
    c, checks["hrnet"] = frame_eval_phase(
        torch, root, work, k, n_frames, reset, counts,
        preset=HRNET_PRESETS["hrnetv2"], name="hrnet_eval",
        label="HRNetV2-W48 c1", per_frame=per["hrnet"],
        load=ckpts["hrnetv2"],
        fault=lambda: patched(hrnet, "resize_bilinear_rt",
                              lambda t, size, *_: hrnet.resize_bilinear(
                                  t, size)))
    launches.update(c)

    # n: hrnetv2_clip through test_clip's window path, TimeAtten's blend
    # weights captured beside each window's logits
    weights = []
    blend = hrnet_clip.TimeAtten.weights

    def recorded(self, *a, **kw):
        w = blend(self, *a, **kw)
        weights.append(w.detach().clone())
        return w

    def run(bucket, tag=""):
        path = "hrnetv2_clip" + tag + ("_bucketed" if bucket else "")
        out_dir = os.path.join(work, "preds_" + path)
        captured = []
        saved = capture_window_logits(test_clip, captured)
        hrnet_clip.TimeAtten.weights = recorded
        reset()
        t0 = time.perf_counter()
        try:
            m, _ = test_clip.main([
                "--cfg", HRNET_PRESETS["hrnetv2_clip"], "--dataroot",
                clip_root,
                "--num_class", str(k), "--method", "hrnetv2_clip",
                "--clip_num", str(HRNET_CLIP_NUM), "--load",
                ckpts["hrnetv2_clip"], "--width_bucket", str(bucket),
                "--is_save", "--saveroot", out_dir, "--seed", "0"])
        finally:
            restore_window_heads(test_clip, saved)
            hrnet_clip.TimeAtten.weights = blend
        secs = time.perf_counter() - t0
        c = counts()
        print(f"{path} window eval (HRNetV2Clip + c1, clip_num "
              f"{HRNET_CLIP_NUM}, 480x853"
              + (" in the 480x896 bucket" if bucket else "")
              + f", {n_frames} frames), host clock: "
              f"{1e3 * secs / n_frames:.1f} ms/frame with model set-up; per "
              f"window (decode, forward, argmax) {m['first_frame_ms']:.1f} ms "
              f"for the first, then {m['frame_ms']:.1f} ms; band_zero "
              f"{c['band_zero'] / n_frames:g} a window (derived "
              f"{per['hrnetv2_clip'] if bucket else 0}); "
              f"mIoU {m['mIoU']:.6f} VC {m['VC']:.6f}; kernel launches {c}")
        if not tag:
            launches[path] = c
            for kname, n in c.items():
                want = per["hrnetv2_clip"] * n_frames if (
                    bucket and kname == "band_zero") else 0
                if n != want:
                    raise SystemExit(f"{kname}: {n} launches on the {path} "
                                     f"path, expected {want}")
        check_pngs(os.path.join(out_dir, "video_000"), n_frames)
        if not (np.isfinite(m["mIoU"]) and np.isfinite(m["VC"])):
            raise SystemExit(f"{path}: non-finite metric")
        out = captured, pngs(out_dir), m, weights[:]
        weights.clear()
        return out

    def weight_gap(exact, other, label):
        if len(exact[3]) != n_frames or len(other[3]) != n_frames:
            raise SystemExit(f"{label}: {len(other[3])} blend weights "
                             f"captured for {n_frames} windows")
        gap = max((b - e).abs().max().item()
                  for e, b in zip(exact[3], other[3]))
        spread = max((e.max() - e.min()).item() for e in exact[3])
        print(f"{label} bucketed vs exact TimeAtten blend weights: max "
              f"|diff| {gap:.3e} (limit {BLEND_WEIGHT_LIMIT:g}); the exact "
              f"weights of a window spread by up to {spread:.3e}")
        return gap

    runs = {b: run(b) for b in (0, 64)}
    checks["hrnetv2_clip"] = window_bucket_check(
        torch, "hrnetv2_clip", runs[0][0], runs[64][0], runs[0][1],
        runs[64][1])
    gap = weight_gap(runs[0], runs[64], "hrnetv2_clip")
    if gap > BLEND_WEIGHT_LIMIT:
        raise SystemExit("hrnetv2_clip: bucketed blend weights disagree "
                         "with exact")
    checks["hrnetv2_clip"].update(
        blend_weight_gap=gap, band_zero_per_window=per["hrnetv2_clip"],
        host_ms_per_window={"exact": runs[0][2]["frame_ms"],
                            "bucketed": runs[64][2]["frame_ms"]})
    with patched(hrnet_clip, "pool_valid",
                 lambda v, _: v.float().mean(dim=(2, 3))):
        planted = run(64, tag="_planted")
    caught = weight_gap(runs[0], planted, "hrnetv2_clip (planted fault)") \
        > BLEND_WEIGHT_LIMIT
    try:
        window_bucket_check(torch, "hrnetv2_clip (planted fault)",
                            runs[0][0], planted[0], runs[0][1], planted[1])
        checks["hrnetv2_clip"]["planted_fault_caught_by_logits"] = False
    except SystemExit:
        checks["hrnetv2_clip"]["planted_fault_caught_by_logits"] = True
        caught = True
    if not caught:
        raise SystemExit("the hrnetv2_clip bucketed eval check missed the "
                         "planted fault")
    checks["hrnetv2_clip"]["planted_fault_caught"] = True
    del runs, planted

    # o: the per-frame trainer with both presets, then OCRNet's eval
    for name, watch in (
            ("hrnetv2", ("encoder.conv1.weight",
                         "decoder.conv_last_1.weight")),
            ("resnet101dilated-ocr_deepsup", ("encoder.conv1.weight",
                                              "decoder.head.weight"))):
        c, checks["train_" + name] = frame_train_phase(
            torch, train_root, work, k, reset, counts,
            preset=HRNET_PRESETS[name], batch=2, trainfps=2, epochs=1,
            watch=watch)
        launches["frame_train_" + name] = c
    c, checks["ocrnet"] = frame_eval_phase(
        torch, root, work, k, n_frames, reset, counts,
        preset=HRNET_PRESETS["resnet101dilated-ocr_deepsup"],
        name="ocrnet_eval", label="R101 ocrnet_deepsup",
        per_frame=per["ocrnet"])
    launches.update(c)
    return launches, checks


#: the per-frame baselines of phase p: (path, preset, trailing overrides,
#: the head's parameter that the train phase watches); ResNeXt-101 has no
#: preset and runs on the R101 UPerNet one
BASELINE_PATHS = (
    ("upernet", "vsp-resnet101-upernet.yaml", (),
     "decoder.conv_last_.1.weight"),
    ("deeplab", "vsp-resnet101dilated-deeplab.yaml", (),
     "decoder.decoder.lastlast_conv.1.weight"),
    ("nonlocal2d", "vsp-resnet101dilated-nonlocal2d.yaml", (),
     "decoder.last_layer.weight"),
    ("mobilenetv2_c1", "vsp-mobilenetv2dilated-c1_deepsup.yaml", (),
     "decoder.conv_last_.weight"),
    ("resnext101_upernet", "vsp-resnet101-upernet.yaml",
     ("MODEL.arch_encoder", "resnext101"), "decoder.conv_last_.1.weight"),
)


def frame_model_band_launches(torch, model):
    """B6's launches a bucketed frame of a per-frame ``SegmentationModule``
    whose every level has a band, from the model: the input of each
    spatial conv of the trunk (ops/masked.py::masked_trunk), a ResNet
    stem's max pool, every level of the trunk (masked_encode), and the
    head's re-zeros: UPerNet's pyramid branches, laterals and finest FPN
    level; DeepLab's low-level features, ASPP's output and its two
    fusion convs; OCRNet's none; C1's, PPM's and Non-local 2D's one (C5,
    or the embedding)."""
    from cvpr2021_vspw_implement_tpu_torch.models import (decoders, deeplab,
                                                          mobilenet, ocr,
                                                          resnet)

    enc, dec = model.encoder, model.decoder
    n = sum(isinstance(m, torch.nn.Conv2d) and max(m.kernel_size) > 1
            for m in enc.modules())
    if isinstance(enc, resnet.ResNetFeatures):
        n += 1 + 4
    elif isinstance(enc, mobilenet.MobileNetV2Dilated):
        n += len(mobilenet.DOWN_IDX) + 1
    else:
        raise TypeError(f"no band count for {type(enc).__name__}")
    if isinstance(dec, decoders.UPerNet):
        return n + len(dec.pool_scales) + len(dec.fpn_in) + 1
    if isinstance(dec, deeplab.DeepLab):
        return n + 2 + 2
    return n + (0 if isinstance(dec, ocr.SpatialOCRNet) else 1)


def baseline_phases(torch, root, train_root, work, k, n_frames, reset,
                    counts):
    """p. The remaining per-frame baselines (:data:`BASELINE_PATHS`): R101
    UPerNet (output stride 32), R101-dilated DeepLabV3+ and Non-local 2D,
    MobileNetV2-dilated + C1 with deep supervision, and ResNeXt-101 +
    UPerNet.  Each seeded, its BatchNorm statistics those of the video's
    first frame and that frame's colours rolled (a batch of 2: DeepLab's
    image pool normalises one value a frame; :func:`calibrate_batchnorm`),
    Non-local 2D's residual scale live first (:func:`live_nonlocal_scale`);
    then the per-frame eval CLI exact and bucketed
    (:func:`frame_eval_phase`, B6 at :func:`frame_model_band_launches` a
    frame), UPerNet's planted fault (its top-down resize on the padded
    size) and DeepLab's (its image pool over the padded grid) each caught;
    then the per-frame trainer, crop 479, batch 2, 4 steps
    (:func:`frame_train_phase`).  Returns (launches by path, checks by
    path)."""
    import numpy as np

    from cvpr2021_vspw_implement_tpu_torch import test as frame_test
    from cvpr2021_vspw_implement_tpu_torch.config import cfg as default_cfg
    from cvpr2021_vspw_implement_tpu_torch.data import TestFrameDataset
    from cvpr2021_vspw_implement_tpu_torch.models import decoders, deeplab
    from cvpr2021_vspw_implement_tpu_torch.ops.interpolate import \
        resize_bilinear

    faults = {
        "upernet": lambda: patched(
            decoders.UPerNet, "top_down",
            staticmethod(lambda f, size, *_: resize_bilinear(f, size))),
        "deeplab": lambda: patched(
            deeplab, "global_avg_pool_rt",
            lambda x, _: x.mean(dim=(2, 3), keepdim=True)),
    }
    presets = os.path.join(REPO, "cvpr2021_vspw_implement_tpu_torch",
                           "config", "presets")
    launches, checks = {}, {}
    for path, name, opts, head in BASELINE_PATHS:
        preset = os.path.join(presets, name)
        cfg = default_cfg.clone()
        cfg.merge_from_file(preset)
        cfg.merge_from_list(list(opts))
        with torch.device("meta"):
            per = frame_model_band_launches(
                torch, frame_test.build_segmentation(cfg, k))
        args = frame_test.build_eval_parser().parse_args(
            ["--cfg", preset, "--num_class", str(k), "--seed", "0", *opts])
        model = frame_test.build_model(cfg, args, "cuda")
        if path == "nonlocal2d":
            live_nonlocal_scale(torch, model.decoder, stats=False)
        x = TestFrameDataset(root, "video_000", args)[0][0]
        x = torch.from_numpy(np.ascontiguousarray(
            x.transpose(2, 0, 1))[None]).cuda()
        calibrate_batchnorm(torch, model, torch.cat([x, x.roll(1, dims=1)]))
        ckpt = os.path.join(work, f"{path}_live.pth")
        torch.save(model.state_dict(), ckpt)
        encoder_param = next(n for n, _ in model.named_parameters())
        del model, x
        c, checks[path] = frame_eval_phase(
            torch, root, work, k, n_frames, reset, counts, preset=preset,
            name=path + "_eval", label=f"{path} ({cfg.MODEL.arch_encoder} "
            f"{cfg.MODEL.arch_decoder})", per_frame=per, load=ckpt,
            fault=faults.get(path), opts=opts)
        launches.update(c)
        c, checks["train_" + path] = frame_train_phase(
            torch, train_root, work, k, reset, counts, preset=preset,
            batch=2, trainfps=2, epochs=1, watch=(encoder_param, head),
            opts=opts, label=path)
        launches["frame_train_" + path] = c
    return launches, checks


#: phase q: the per-frame trainer's restart runs, 2 epochs of 4 steps
#: (8 frames of 480x853 at batch 2; the schedule over the same 8 steps)
RESUME_EPOCHS, RESUME_STEPS = 2, 4


#: the per-frame trainer's CLI under :func:`deterministic_algorithms`, as
#: ``python -c`` runs it (its arguments follow)
DETERMINISTIC_TRAIN_CLI = (
    "import runpy, torch; torch.backends.cudnn.deterministic = True; "
    "torch.use_deterministic_algorithms(True, warn_only=True); "
    "runpy.run_module('cvpr2021_vspw_implement_tpu_torch.train', "
    "run_name='__main__', alter_sys=True)")


@contextlib.contextmanager
def deterministic_algorithms(torch):
    """cuDNN's deterministic algorithms, and PyTorch's where it has them
    (others warn), for the block; the settings before it come back."""
    saved = (torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])


def checkpoint_gap(torch, a, b):
    """Two trainer checkpoints (utils/checkpoint.py): the largest relative
    difference of their floating tensors, max |a - b| / max |a| a tensor,
    for the model (parameters and BatchNorm statistics, whose magnitudes
    span 1e-4 to 1e10 with the seeded R101) and for the optimizer's
    momentum; and the names of the parts that must be equal and are not
    (the step, the epoch, the scheduler, the learning rates, the dropout
    generator's state, integer buffers)."""
    gaps, differ = {"model": 0.0, "optimizer": 0.0}, []

    def walk(x, y, where):
        if isinstance(x, dict) and isinstance(y, dict) and \
                x.keys() == y.keys():
            for key in x:
                walk(x[key], y[key], f"{where}/{key}")
        elif isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)) \
                and len(x) == len(y):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{where}/{i}")
        elif isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) \
                and x.shape == y.shape and x.dtype == y.dtype:
            if x.is_floating_point():
                if x.numel():
                    x, y = x.double(), y.double()
                    rel = ((x - y).abs().max()
                           / x.abs().max().clamp_min(1e-30)).item()
                    part = where.split("/")[1]
                    gaps[part] = max(gaps[part], rel)
            elif not torch.equal(x, y):
                differ.append(where)
        elif isinstance(x, torch.Tensor) or x != y:
            differ.append(where)

    walk(a, b, "")
    return gaps, differ


def resume_phases(torch, work, k, hw, reset, counts, preset=FRAME_PRESET,
                  device="cuda", crop=479):
    """q. The per-frame trainer's restart and data flags with ``preset``
    (R101-dilated ``ppm_deepsup``: fc_dim 2048, 124 classes), crop 479,
    batch 2, over 8 synthetic frames (2 epochs of 4 steps, the schedule
    over those 8 steps): the uninterrupted run and a control (the same run
    again); the same run in a child process (the trainer's CLI) that gets
    a real SIGTERM once step 5 is logged, while it runs step 6, and must
    exit 0 with ``preempt_6.pth`` beside the first epoch's save; then
    ``--resume`` from that file, whose final checkpoint must be the
    uninterrupted run's bitwise: the step, epoch, scheduler and dropout
    generator, the model with its BatchNorm statistics and the momentum.
    Every run goes through :func:`deterministic_algorithms` (the caller's
    block, the child's :data:`DETERMINISTIC_TRAIN_CLI`): otherwise cuDNN's
    convolution gradients sum in no fixed order, and the seeded R101
    amplifies that past any bar within a few steps (PERF.md §6).  The
    control's gap is printed beside the resumed run's.  Two planted faults, the resume
    without the scheduler's state and without the dropout generator's,
    must fail that check.
    Then ``--usetwodata`` (a second synthetic root), ``--refrng`` and
    ``--profile_dir``, 4 steps each: their data wait; the trace must hold
    cuDNN's convolution kernels, and its steps' time beside the untraced
    run's is the profiler's overhead.  Checkpoint size and save time, and
    the resume's load time.  No kernel of the port's may launch.  Returns
    (launches by path, numbers)."""
    import signal
    import shutil

    from cvpr2021_vspw_implement_tpu_torch import train as frame_train
    from cvpr2021_vspw_implement_tpu_torch.data import make_synthetic_vspw
    from cvpr2021_vspw_implement_tpu_torch.utils import checkpoint

    first, second = (os.path.join(work, "vspw_resume"),
                     os.path.join(work, "vspw_second"))
    make_synthetic_vspw(first, 2, 4, hw, k, seed=3, splits=("train",))
    make_synthetic_vspw(second, 2, 4, hw, k, seed=4, splits=("train",))

    def ckpt_dir(name):
        return os.path.join(work, "q_" + name)

    def argv(name, *extra, epochs=RESUME_EPOCHS):
        return ["--cfg", preset, "--dataroot", first, "--num_class", str(k),
                "--batchsize", "2", "--cropsize", str(crop), "--trainfps",
                "15", "--lr", "0.002", "--totalepoch", str(epochs),
                "--validation", "False", "--seed", "0", "--device", device,
                *extra,
                "DIR", ckpt_dir(name), "TRAIN.epoch_iters",
                str(RESUME_STEPS), "TRAIN.disp_iter", "1"]

    launches, runs = {}, {}

    def run(name, *extra, epochs=RESUME_EPOCHS):
        """One in-process run of the trainer's CLI: its steps (host
        clock, synchronised), its saves (seconds, bytes) and loads
        (seconds)."""
        records, saves, loads = [], [], []
        save, load = checkpoint.save_checkpoint, checkpoint.load_checkpoint

        def timed(fn, sink, size):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                sink.append((time.perf_counter() - t0,
                             os.path.getsize(out if size else a[0])))
                return out
            return call

        step = step_timer(frame_train, records)
        reset()
        try:
            with patched(checkpoint, "save_checkpoint",
                         timed(save, saves, True)), \
                    patched(checkpoint, "load_checkpoint",
                            timed(load, loads, False)):
                frame_train.main(argv(name, *extra, epochs=epochs))
        finally:
            frame_train.train_step = step
        launches["frame_" + name] = c = counts()
        losses = [r[2] for r in records]
        if any(c.values()) or not all(math.isfinite(v) for v in losses):
            raise SystemExit(f"per-frame train ({name}): launches {c}, "
                             f"losses {losses}")
        runs[name] = {"step_ms": [1e3 * (r[1] - r[0]) for r in records],
                      "losses": losses, "saves": saves, "loads": loads,
                      "data_wait_ms": data_waits_ms(records, RESUME_STEPS)}
        return runs[name]

    run("uninterrupted")
    run("control")

    # the child: SIGTERM once step 5 is logged (the loop reads the flag
    # after each step, and step 6 takes far longer than the signal's way)
    os.makedirs(ckpt_dir("preempt"), exist_ok=True)
    child = subprocess.Popen(
        [sys.executable, "-u", "-c", DETERMINISTIC_TRAIN_CLI,
         *argv("preempt")], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines, sent = [], None
    try:
        for line in child.stdout:
            lines.append(line)
            if sent is None and f"Epoch: [1][0/{RESUME_STEPS}]" in line:
                child.send_signal(signal.SIGTERM)
                sent = time.perf_counter()
        rc = child.wait(timeout=600)
        exited_s = time.perf_counter() - sent if sent else None
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    files = sorted(os.listdir(ckpt_dir("preempt")))
    if rc != 0 or sent is None or files != [
            "config.yaml", "model_epoch_1.pth", "preempt_6.pth"]:
        raise SystemExit(f"preempted child: rc {rc}, signal sent "
                         f"{sent is not None}, files {files}; its output "
                         f"ends {''.join(lines[-15:])}")
    held = torch.load(os.path.join(ckpt_dir("preempt"), "preempt_6.pth"),
                      map_location="cpu")
    if (held["step"], held["epoch"]) != (6, 1):
        raise SystemExit(f"preempt_6.pth holds step {held['step']}, epoch "
                         f"{held['epoch']}")
    del held
    print(f"train frame, preempted child: SIGTERM after step 5's line, "
          f"exit 0 {exited_s:.1f} s later with {files}")

    def resume(name):
        os.makedirs(ckpt_dir(name), exist_ok=True)
        src = os.path.join(ckpt_dir("preempt"), "preempt_6.pth")
        dst = os.path.join(ckpt_dir(name), "preempt_6.pth")
        try:
            os.link(src, dst)
        except OSError:
            shutil.copyfile(src, dst)
        return run(name, "--resume", "true")

    resume("resumed")
    from torch.optim.lr_scheduler import LambdaLR
    faults = {"without_scheduler": lambda: patched(
                  LambdaLR, "load_state_dict", lambda self, state: None),
              "without_dropout_rng": lambda: patched(
                  checkpoint, "restore_rng", lambda gen, state: None)}
    for name, fault in faults.items():
        with fault():
            resume("fault_" + name)

    def final(name):
        return torch.load(os.path.join(ckpt_dir(name), "model_epoch_2.pth"),
                          map_location="cpu")

    ref = final("uninterrupted")
    control_gaps, control_differ = checkpoint_gap(torch, ref,
                                                  final("control"))
    held = {}
    for name in ("resumed", *("fault_" + f for f in faults)):
        gaps, differ = checkpoint_gap(torch, ref, final(name))
        held[name] = {"gaps": gaps, "differ": differ,
                      "ok": not differ and not any(gaps.values()),
                      "losses_7_8": runs[name]["losses"]}

    def text(gaps):
        return ", ".join(f"{p} {g:.3e}" for p, g in gaps.items())

    print(f"train frame --resume after the preemption at step 6, under "
          f"deterministic algorithms: final state from the uninterrupted "
          f"run's (largest relative gap a tensor) "
          f"{text(held['resumed']['gaps'])} (limit 0, bitwise); control, "
          f"two uninterrupted runs: {text(control_gaps)}, parts that differ "
          f"{control_differ}; parts that differ "
          f"{held['resumed']['differ']}; losses of steps 7-8: resumed "
          f"{held['resumed']['losses_7_8']}, uninterrupted "
          f"{runs['uninterrupted']['losses'][6:]}, control "
          f"{runs['control']['losses'][6:]}; planted faults: "
          + "; ".join(f"{n} {text(held['fault_' + n]['gaps'])}, differ "
                      f"{held['fault_' + n]['differ']}" for n in faults))
    if not held["resumed"]["ok"]:
        raise SystemExit(f"resumed run off the uninterrupted one: {held}, "
                         f"control {control_gaps}, {control_differ}")
    for name in faults:
        if held["fault_" + name]["ok"]:
            raise SystemExit(f"planted fault {name}: the resume check "
                             "passed")

    run("twodata", "--usetwodata", "true", "--dataroot2", second, epochs=1)
    run("refrng", "--refrng", "true", epochs=1)
    prof_dir = os.path.join(work, "q_trace")
    shutil.rmtree(prof_dir, ignore_errors=True)
    run("profile", "--profile_dir", prof_dir, epochs=1)
    traces = os.listdir(prof_dir)
    with open(os.path.join(prof_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    ops = {e.get("name", "") for e in events if e.get("cat") == "cpu_op"}
    kernel_names = [e.get("name", "") for e in events
                    if e.get("cat") == "kernel"]
    cudnn = sorted({n for n in kernel_names
                    if any(w in n.lower() for w in ("cudnn", "xmma",
                                                    "implicit_gemm"))})
    steps = sum(e.get("name") == "train_step" for e in events
                if e.get("cat") == "user_annotation")
    print(f"train frame --profile_dir: {traces}, {len(events)} events, "
          f"{len(kernel_names)} kernel launches, {steps} train_step ranges; "
          f"cuDNN kernels, first 3 of {len(cudnn)}: {cudnn[:3]}")
    if (len(traces) != 1 or "aten::cudnn_convolution" not in ops
            or not cudnn or steps != frame_train.PROFILE_LAST_STEP + 1):
        raise SystemExit(f"profile trace: files {traces}, cudnn op "
                         f"{'aten::cudnn_convolution' in ops}, cuDNN "
                         f"kernels {len(cudnn)}, steps {steps}")

    def steady(name):
        return sum(runs[name]["step_ms"][1:4]) / 3

    saves = [s for r in runs.values() for s in r["saves"]]
    numbers = {
        "control_gaps": control_gaps, "held": held,
        "checkpoint_bytes": saves[0][1],
        "save_s": [round(t, 4) for t, _ in saves],
        "load_s": runs["resumed"]["loads"][0][0],
        "child_exit_s_after_signal": exited_s,
        "step_ms": {n: r["step_ms"] for n, r in runs.items()},
        "data_wait_ms": {n: runs[n]["data_wait_ms"] for n in
                         ("uninterrupted", "twodata", "refrng", "profile")},
        "profiled_step_ms": steady("profile"),
        "unprofiled_step_ms": steady("uninterrupted"),
    }
    print(f"train frame, R101 ppm_deepsup checkpoint {saves[0][1] / 2**20:.1f}"
          f" MiB, saved in {min(t for t, _ in saves):.3f}-"
          f"{max(t for t, _ in saves):.3f} s; the resume loads it in "
          f"{numbers['load_s']:.3f} s; steps 2-4, ms: uninterrupted "
          f"{steady('uninterrupted'):.1f}, --usetwodata (batch 2 + 2) "
          f"{steady('twodata'):.1f}, --refrng {steady('refrng'):.1f}, "
          f"--profile_dir {steady('profile'):.1f} (the profiler's overhead "
          f"{steady('profile') - steady('uninterrupted'):+.1f} ms a step); "
          f"data wait inside an epoch, ms: "
          + ", ".join(f"{n} {[round(w, 1) for w in v]}"
                      for n, v in numbers["data_wait_ms"].items()))
    return launches, numbers


def demo_phase(torch, root, work, raft_ckpt, reset, counts, iters=20,
               device="cuda"):
    """r. ``demo.py`` over the video's frames (480x853: RAFT at 60x107, so
    B1 once and B4 twice a refinement, 20 and 40 a pair at ``iters`` 20),
    with RAFT from ``raft_ckpt``: a flow PNG a pair, finite flows, the
    launches at their derived counts; the device ms of a pair
    (``tc_cal.pair_flow``, CUDA events); one pair's flow on the card
    against the CPU's after RAFT's first refinement, within
    TC_FLOW_LIMIT_PX (with random weights the 20 refinements amplify f32
    rounding, :func:`tc_flow_check`), and after all 20, printed.  Returns
    (launches, numbers)."""
    import copy

    import numpy as np
    from PIL import Image

    from cvpr2021_vspw_implement_tpu_torch import demo, tc_cal

    vdir = os.path.join(root, "data", "video_000", "origin")
    names = sorted(os.listdir(vdir))
    pairs, out = len(names) - 1, os.path.join(work, "flow_demo")
    reset()
    t0 = time.perf_counter()
    flows = demo.main(["--path", vdir, "--out", out, "--raft_ckpt",
                       raft_ckpt, "--iters", str(iters), "--device", device])
    secs = time.perf_counter() - t0
    c = counts()
    want = {"corr_lookup": 20 * pairs, "sep_gru": 40 * pairs}
    pngs = sorted(os.listdir(out))
    hw = np.asarray(Image.open(os.path.join(vdir, names[0]))).shape[:2]
    if any(n != want.get(name, 0) for name, n in c.items()):
        raise SystemExit(f"demo: launches {c}, expected {want}")
    if len(pngs) != pairs or len(flows) != pairs or any(
            f.shape != (*hw, 2) or not np.isfinite(f).all() for f in flows):
        raise SystemExit(f"demo: {len(pngs)} PNGs, flows "
                         f"{[f.shape for f in flows]}")
    for name in pngs:
        if np.asarray(Image.open(os.path.join(out, name))).shape != (*hw, 3):
            raise SystemExit(f"demo: bad flow PNG {name}")

    args = argparse.Namespace(raft_ckpt=raft_ckpt, allow_random_raft=False,
                              raft_iters=iters, seed=0)
    raft = tc_cal.build_raft(args, device)
    cpu_raft = copy.deepcopy(raft).cpu()

    def load(name, dev):
        img = np.asarray(Image.open(os.path.join(vdir, name)).convert("RGB"),
                         np.float32)
        return torch.from_numpy(img).permute(2, 0, 1)[None].to(dev)

    pair = [load(n, device) for n in names[:2]]
    pair_ms = cuda_ms(lambda: tc_cal.pair_flow(raft, *pair, 0), n=5, warm=1)
    gaps = {}
    for n_iter in (1, iters):
        with raft_iters(raft, n_iter), raft_iters(cpu_raft, n_iter):
            card = tc_cal.pair_flow(raft, *pair, 0).cpu()
            host = tc_cal.pair_flow(cpu_raft, *[load(n, "cpu")
                                                for n in names[:2]], 0)
        gaps[n_iter] = (card - host).abs().max().item()
    print(f"demo (RAFT {iters} refinements, {pairs} pairs of {hw[0]}x"
          f"{hw[1]}): {1e3 * secs / pairs:.1f} ms a pair on the host clock "
          f"(with RAFT's set-up, decode and PNG), {pair_ms:.2f} ms a pair "
          f"on the device (CUDA events); kernel launches {c}; a pair's flow "
          f"card against CPU: {gaps[1]:.3e} px after 1 refinement (limit "
          f"{TC_FLOW_LIMIT_PX}), {gaps[iters]:.3e} px after {iters} (not "
          f"held: random weights amplify rounding)")
    if not gaps[1] <= TC_FLOW_LIMIT_PX:
        raise SystemExit(f"demo: card and CPU flows {gaps[1]} px apart")
    return c, {"host_ms_per_pair": 1e3 * secs / pairs,
               "device_ms_per_pair": pair_ms,
               "card_vs_cpu_px": {str(n): g for n, g in gaps.items()}}


def torch_load_phase(torch, test_clip, root, work, k, preset, per_frame,
                     n_frames, reset, counts, pngs, exact_dir, bucket_dir):
    """t. ``test_clip --torch_load`` of phase a's seeded ClipPSP saved as a
    reference fused ``.pth`` (DataParallel ``module.`` names), over a seed-1
    init, exact (``--eval_policy exact --width_bucket 0``) and at the CLI's
    default, bucketed (B6 at ``per_frame`` a frame): the PNGs must be
    phase a's and a''s.  Returns launches by path."""
    from cvpr2021_vspw_implement_tpu_torch.config import cfg as default_cfg

    cfg = default_cfg.clone()
    cfg.merge_from_file(preset)
    args = test_clip.build_eval_clip_parser().parse_args(
        ["--cfg", preset, "--num_class", str(k), "--seed", "0"])
    fused = os.path.join(work, "fused_clip_psp.pth")
    torch.save({"module." + n: t for n, t in test_clip.build_model(
        cfg, args, "cpu").state_dict().items()}, fused)
    launches = {}
    for bucket, want_dir in ((0, exact_dir), (64, bucket_dir)):
        name = "torch_load" + ("_bucketed" if bucket else "")
        out = os.path.join(work, "preds_" + name)
        reset()
        t0 = time.perf_counter()
        test_clip.main(["--cfg", preset, "--dataroot", root, "--num_class",
                        str(k), "--method", "clip_psp", "--torch_load",
                        fused, "--seed", "1", "--is_save", "--saveroot", out,
                        *([] if bucket else ["--eval_policy", "exact",
                                             "--width_bucket", "0"])])
        secs = time.perf_counter() - t0
        launches[name] = c = counts()
        want = {"band_zero": per_frame * n_frames if bucket else 0}
        same = [bool((a == b).all()) for a, b in zip(pngs(out),
                                                      pngs(want_dir))]
        phase = "a'" if bucket else "a"
        print(f"test_clip --torch_load, {'bucketed' if bucket else 'exact'}"
              f": {1e3 * secs / n_frames:.1f} ms a frame with set-up; PNGs "
              f"equal to phase {phase}'s: {sum(same)} of {len(same)}; "
              f"kernel launches {c}")
        if len(same) != n_frames or not all(same) or any(
                n != want.get(kn, 0) for kn, n in c.items()):
            raise SystemExit(f"{name}: PNGs equal {same}, launches {c}")
    return launches


def main() -> int:
    import numpy as np
    import torch
    from PIL import Image

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from cvpr2021_vspw_implement_tpu_torch import (bench, kernels, tc_cal,
                                                   test_clip)
    from cvpr2021_vspw_implement_tpu_torch.data import make_synthetic_vspw

    wrappers = bench.WRAPPERS
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
    ptxas = [f"{name}: {line}"
             for name in ("sep_gru", "gru_flowhead", "motion_encoder",
                          "local_agg", "local_agg_bwd", "corr_lookup",
                          "band_zero")
             for line in ptxas_lines(logs.get(name, ""))]
    for line in ptxas:
        print(f"ptxas: {line}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    clocks_first = smi_clocks()
    print(f"card clocks before the kernel checks (SM, SM max, power, "
          f"temperature): {clocks_first}")
    rows = check_kernels(torch)
    rows += check_local_agg_backward(torch)
    routes = update_block_routes(torch)
    small_input_agreement(torch)
    clip_warp_agreement(torch)
    train_step_agreement(torch)
    warp_train_agreement(torch)

    work = os.path.join(REPO, "build", "chip_smoke")
    root, preds = os.path.join(work, "vspw"), os.path.join(work, "preds")
    n_frames, hw, k = 10, (480, 853), 124
    make_synthetic_vspw(root, 1, n_frames, hw, k, seed=0)
    host_ops = native_host_ops(root)
    preset = os.path.join(REPO, "cvpr2021_vspw_implement_tpu_torch", "config",
                          "presets",
                          "vsp-resnet101dilated-ppm_deepsup_clip.yaml")

    def reset():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {n: fn.launches for n, fn in wrappers.items()}

    reset()
    t0 = time.perf_counter()
    metrics, _ = test_clip.main([
        "--cfg", preset, "--dataroot", root, "--num_class", str(k),
        "--method", "clip_psp", "--eval_policy", "exact", "--width_bucket",
        "0", "--is_save", "--saveroot", preds, "--seed", "0"])
    eval_s = time.perf_counter() - t0
    eval_counts = counts()
    print(f"TCB-PSP streaming eval, exact shapes (R101, 480x853, {n_frames} "
          f"frames): {1e3 * eval_s / n_frames:.1f} ms/frame including the "
          f"first frame; mIoU {metrics['mIoU']:.6f} VC {metrics['VC']:.6f}; "
          f"kernel launches {eval_counts}")
    if any(eval_counts.values()):
        raise SystemExit("the exact eval path launched a kernel")

    # RAFT of both TC phases: the seeded init with a trained-like flow head
    iters, pairs = 20, n_frames - 1
    raft = scale_flow_head(torch, tc_cal.build_raft(
        tc_cal.build_parser().parse_args(
            ["--dataroot", root, "--predroot", preds, "--allow_random_raft",
             "--raft_iters", str(iters), "--seed", "0"]), "cpu"))
    raft_ckpt = os.path.join(work, "raft.pth")
    os.makedirs(work, exist_ok=True)
    torch.save(raft.state_dict(), raft_ckpt)

    def run_tc(pred_dir, bucket):
        reset()
        t0 = time.perf_counter()
        tc = tc_cal.main([
            "--dataroot", root, "--predroot", pred_dir, "--num_class", str(k),
            "--raft_ckpt", raft_ckpt, "--raft_iters", str(iters),
            "--width_bucket", str(bucket)])
        return tc, time.perf_counter() - t0, counts()

    tc, tc_s, tc_counts = run_tc(preds, 0)
    print(f"TC, exact shapes (RAFT {iters} iters, {pairs} pairs): "
          f"{1e3 * tc_s / pairs:.1f} ms/pair; TC {tc:.6f}; kernel launches "
          f"{tc_counts}")
    for name, per_pair in (("corr_lookup", 20), ("sep_gru", 40)):
        if tc_counts[name] != per_pair * pairs:
            raise SystemExit(f"{name}: {tc_counts[name]} launches in the TC "
                             f"phase, expected {per_pair * pairs}")

    # the same eval and TC at the CLIs' defaults: width-bucketed.  The band
    # re-zero's launches, derived from the code: in the R101 trunk the input
    # of every spatial conv (ops/masked.py::masked_trunk), the stem max pool,
    # C5 in encode_frame and in fuse_target; in RAFT the input of every
    # spatial conv of both encoders, the 4 pyramid levels, a refinement's
    # spatial convs of the motion encoder and flow head with the GRU's 4
    # (x once, h before each pass and at the end), the mask head's spatial
    # conv and the low-resolution flow.  At 480x853 in the 480x896 bucket
    # every one of them has a band.
    per_frame, per_pair = band_zero_launches(torch, raft)
    preds_b = os.path.join(work, "preds_bucketed")
    reset()
    t0 = time.perf_counter()
    metrics_b, _ = test_clip.main([
        "--cfg", preset, "--dataroot", root, "--num_class", str(k),
        "--method", "clip_psp", "--is_save", "--saveroot", preds_b,
        "--seed", "0"])
    eval_b_s = time.perf_counter() - t0
    eval_b_counts = counts()
    print(f"TCB-PSP streaming eval, bucketed (the default; buckets "
          f"{metrics_b['buckets']}): {1e3 * eval_b_s / n_frames:.1f} ms/frame "
          f"including the first frame (exact: "
          f"{1e3 * eval_s / n_frames:.1f}); mIoU {metrics_b['mIoU']:.6f} VC "
          f"{metrics_b['VC']:.6f}; band_zero {eval_b_counts['band_zero']} "
          f"launches, {eval_b_counts['band_zero'] / n_frames:g} a frame "
          f"(derived {per_frame}); kernel launches {eval_b_counts}")
    if metrics_b["buckets"] != [(480, 896)]:
        raise SystemExit(f"bucketed eval touched {metrics_b['buckets']}, "
                         "expected the one bucket 480x896")
    for name, n in eval_b_counts.items():
        want = per_frame * n_frames if name == "band_zero" else 0
        if n != want:
            raise SystemExit(f"{name}: {n} launches in the bucketed eval, "
                             f"expected {want}")

    tc_b, tc_b_s, tc_b_counts = run_tc(preds_b, 64)
    print(f"TC, bucketed (the default): {1e3 * tc_b_s / pairs:.1f} ms/pair "
          f"(exact: {1e3 * tc_s / pairs:.1f}); TC {tc_b:.6f} (exact "
          f"{tc:.6f}, |diff| {abs(tc_b - tc):.3e}); band_zero "
          f"{tc_b_counts['band_zero'] / pairs:g} launches a pair (derived "
          f"{per_pair}); kernel launches {tc_b_counts}")
    for name, n in tc_b_counts.items():
        want = {"corr_lookup": 20, "sep_gru": 40,
                "band_zero": per_pair}.get(name, 0) * pairs
        if n != want:
            raise SystemExit(f"{name}: {n} launches in the bucketed TC, "
                             f"expected {want}")
    # bucketed against exact TC, pair by pair on the flows (their TC values
    # are too coarse to tell a bucketing fault from RAFT's rounding noise)
    def load(path, dtype):
        return torch.from_numpy(np.asarray(Image.open(path), dtype)).cuda()

    vdir = os.path.join(root, "data", "video_000", "origin")
    names = sorted(os.listdir(vdir))
    images = [load(os.path.join(vdir, n), np.float32).permute(2, 0, 1)[None]
              for n in names]
    next_preds = [load(os.path.join(preds, "video_000",
                                    os.path.splitext(n)[0] + ".png"),
                       np.int32)[None] for n in names[1:]]
    tc_check = tc_flow_check(torch, raft.cuda(),
                             list(zip(images, images[1:])), next_preds)
    del images, next_preds

    # the bucket tax, host clock: the first run of a path also pays the
    # first use of its shapes, so both are run again in the other order
    # (exact, bucketed, bucketed, exact), without PNG dumps; "without set-up"
    # drops the model build (evaluate_clip's frame times: the first prediction
    # waits for the 10 encodes, the rest are fuses)
    def frames_ms(m):
        return (m["first_frame_ms"] + (n_frames - 1) * m["frame_ms"]) / n_frames

    runs = {"exact": [(eval_s, metrics)], "bucketed": [(eval_b_s, metrics_b)]}
    for policy in ("bucketed", "exact"):
        t0 = time.perf_counter()
        m, _ = test_clip.main([
            "--cfg", preset, "--dataroot", root, "--num_class", str(k),
            "--method", "clip_psp", "--eval_policy", policy, "--seed", "0"])
        runs[policy].append((time.perf_counter() - t0, m))
    tc_runs = {"exact": [tc_s], "bucketed": [tc_b_s]}
    for bucket, pred_dir in ((64, preds_b), (0, preds)):
        tc_runs["bucketed" if bucket else "exact"].append(
            run_tc(pred_dir, bucket)[1])
    tax = {}
    for policy in ("exact", "bucketed"):
        with_setup = [1e3 * t / n_frames for t, _ in runs[policy]]
        without = [frames_ms(m) for _, m in runs[policy]]
        pair_ms = [1e3 * t / pairs for t in tc_runs[policy]]
        tax[policy] = {"eval_ms_per_frame": with_setup,
                       "eval_ms_per_frame_without_setup": without,
                       "tc_ms_per_pair": pair_ms}
        print(f"{policy}, runs 1 and 2 (order exact, bucketed, bucketed, "
              f"exact): eval {with_setup[0]:.1f}, {with_setup[1]:.1f} "
              f"ms/frame with model set-up, {without[0]:.1f}, "
              f"{without[1]:.1f} without; TC {pair_ms[0]:.1f}, "
              f"{pair_ms[1]:.1f} ms/pair")

    def check_pngs(pred_dir, n):
        names = sorted(os.listdir(pred_dir))
        if len(names) != n:
            raise SystemExit(f"expected {n} prediction PNGs in {pred_dir}, "
                             f"got {len(names)}")
        for name in names:
            pred = np.asarray(Image.open(os.path.join(pred_dir, name)))
            if pred.shape != hw or pred.max() >= k:
                raise SystemExit(f"bad prediction {name}: {pred.shape}, "
                                 f"max {pred.max()}")

    check_pngs(os.path.join(preds, "video_000"), n_frames)
    check_pngs(os.path.join(preds_b, "video_000"), n_frames)
    if not all(np.isfinite(v) for v in (metrics["mIoU"], metrics["VC"], tc,
                                        metrics_b["mIoU"], metrics_b["VC"],
                                        tc_b)):
        raise SystemExit("non-finite metric")

    def pngs(pred_dir):
        d = os.path.join(pred_dir, "video_000")
        return [np.asarray(Image.open(os.path.join(d, n)))
                for n in sorted(os.listdir(d))]

    from cvpr2021_vspw_implement_tpu_torch.config import cfg as default_cfg
    from cvpr2021_vspw_implement_tpu_torch.data import TestFrameDataset
    eval_args = test_clip.build_eval_clip_parser().parse_args(
        ["--cfg", preset, "--num_class", str(k), "--seed", "0"])
    eval_cfg = default_cfg.clone()
    eval_cfg.merge_from_file(preset)
    ds = TestFrameDataset(root, "video_000", eval_args)
    bucket_check = bucketed_vs_exact(
        torch, test_clip.build_model(eval_cfg, eval_args, "cuda"),
        [ds[i][0] for i in range(len(ds))], pngs(preds), pngs(preds_b))

    # the trainer: 4 videos of 12 frames (the 3,6,9 offsets need an anchor
    # with 9 frames after it), batch 2: two steps an epoch
    train_root, steps, iters = os.path.join(work, "vspw_train"), 4, 20
    make_synthetic_vspw(train_root, 4, 12, hw, k, seed=1, splits=("train",))
    reset()
    train_phase(
        torch, "clip_psp", ["--clip_num", "4", "--dilation2", "3,6,9"],
        train_root, work, preset, k, steps)
    psp_counts = counts()
    print(f"kernel launches in the clip_psp train phase {psp_counts}")
    reset()
    etc = train_phase(
        torch, "ETC", ["--clip_num", "2", "--dilation_num", "0",
                       "--st_weight", "0.1"],
        train_root, work, preset, k, steps)
    etc_counts = counts()
    print(f"kernel launches in the ETC train phase {etc_counts} "
          f"({steps} steps, RAFT at {iters} refinements)")
    for name in ("corr_lookup", "motion_encoder", "gru_flowhead"):
        if etc_counts[name] != iters * steps:
            raise SystemExit(f"{name}: {etc_counts[name]} launches in the "
                             f"ETC phase, expected {iters * steps}")
    # where an ETC step's time goes: its frozen RAFT alone, at the step's
    # shape (the pair of 479 crops padded to 480, batch 2)
    pair = 255 * torch.rand(2, 2, 3, 480, 480, device="cuda")
    with torch.no_grad():
        raft_ms = cuda_ms(lambda: etc.raft(pair[0], pair[1]), n=5, warm=1)
    per_iter = rows[0]["also_at"][0]["ms"] + sum(
        r["ms"] for r in rows if r["name"] in ("motion_encoder",
                                               "gru_flowhead"))
    print(f"RAFT forward inside an ETC step (batch 2, 480x480, {iters} "
          f"refinements): {raft_ms:.1f} ms, of which the three kernels "
          f"{iters} x {per_iter:.3f} = {iters * per_iter:.1f} ms (each timed "
          "at 2x60x60)")
    del etc

    # the window methods' training: our_warp in each mode (3 B5 forward and
    # 3 backward launches of the mode a step), our_warp_merge (1 and 1,
    # Cd 256) and propnet (no kernel)
    train_counts = {}
    warp_flags = ["--clip_num", "4", "--max_distances", "10"]
    for path, method, flags, head, b5, mode, b5_only in TRAIN_PATHS:
        reset()
        train_phase(torch, method, warp_flags + flags, train_root, work,
                    preset, k, steps, head=head, name=path, b5=mode,
                    b5_only=b5_only)
        train_counts[path] = c = counts()
        want = {f"local_{mode}_aggregate": b5 * steps,
                f"local_{mode}_aggregate_backward": b5 * steps} if b5 else {}
        print(f"kernel launches in the {path} phase {c}")
        for kname, n in c.items():
            if n != want.get(kname, 0):
                raise SystemExit(f"{kname}: {n} launches on the {path} "
                                 f"path, expected {want.get(kname, 0)}")

    # the window eval path over the 10-frame video, each method exact
    # (--width_bucket 0) then at the CLI's default, bucketed in 480x896:
    # our_warp in its three modes, ETC, propnet and our_warp_merge
    per_window = window_band_launches(torch)
    window_counts, window_checks = {}, {}
    for path, method, flags, b5 in WINDOW_PATHS:
        mode = {"our_warp_softmax": "softmax",
                "our_warp_nearest": "nearest"}.get(path, "sigmoid")
        runs = {}
        for bucket in (0, 64):
            name = path + ("_bucketed" if bucket else "")
            out_dir = os.path.join(work, "preds_" + name)
            captured = []
            saved = capture_window_logits(test_clip, captured)
            reset()
            t0 = time.perf_counter()
            try:
                m, _ = test_clip.main([
                    "--cfg", preset, "--dataroot", root, "--num_class",
                    str(k), "--method", method, *flags, "--width_bucket",
                    str(bucket), "--is_save", "--saveroot", out_dir,
                    "--seed", "0"])
            finally:
                restore_window_heads(test_clip, saved)
            secs = time.perf_counter() - t0
            window_counts[name] = c = counts()
            print(f"{name} window eval (R101, 480x853"
                  + (" in the 480x896 bucket" if bucket else "")
                  + f", {n_frames} frames), host clock: "
                  f"{1e3 * secs / n_frames:.1f} ms/frame including the first "
                  f"frame and model set-up; per window (evaluate_clip's frame "
                  f"times: decode, forward, argmax) {m['first_frame_ms']:.1f} "
                  f"ms for the first, then {m['frame_ms']:.1f} ms; mIoU "
                  f"{m['mIoU']:.6f} VC {m['VC']:.6f}; kernel launches {c}")
            want = {f"local_{mode}_aggregate": b5 * n_frames,
                    "band_zero": per_window[path] * n_frames if bucket else 0}
            for kname, n in c.items():
                if n != want.get(kname, 0):
                    raise SystemExit(f"{kname}: {n} launches on the {name} "
                                     f"path, expected {want.get(kname, 0)}")
            check_pngs(os.path.join(out_dir, "video_000"), n_frames)
            if not (np.isfinite(m["mIoU"]) and np.isfinite(m["VC"])):
                raise SystemExit(f"{name}: non-finite metric")
            runs[bucket] = (captured, pngs(out_dir), m)
        window_checks[path] = window_bucket_check(
            torch, path, runs[0][0], runs[64][0], runs[0][1], runs[64][1])
        window_checks[path]["host_ms_per_window"] = {
            "exact": runs[0][2]["frame_ms"], "bucketed": runs[64][2]["frame_ms"]}
        del runs

    # f, g: the per-frame path, eval (exact, then bucketed) and training;
    # then the clip trainer's loop, serial walk against the prefetch loader
    frame_counts, frame_check = frame_eval_phase(torch, root, work, k,
                                                 n_frames, reset, counts)
    frame_counts["frame_train"], frame_train = frame_train_phase(
        torch, train_root, work, k, reset, counts)
    loader = loader_comparison()

    # h, i: TCB-OCR and NetWarp, eval (exact, then bucketed) and training
    ocr_counts, ocr_checks = ocr_netwarp_eval_phases(
        torch, test_clip, root, work, k, n_frames, reset, counts, raft,
        check_pngs, pngs)
    ocr_counts.update(ocr_netwarp_train_phases(torch, train_root, work, k,
                                               steps, reset, counts))

    # j, k, l: TDNet (over a longer video: every path warm three times) and
    # Non-local 3D, eval (exact, then bucketed) and training
    td_root = os.path.join(work, "vspw_tdnet")
    make_synthetic_vspw(td_root, 1, TDNET_FRAMES, hw, k, seed=2)
    td_counts, td_checks = tdnet_nonlocal3d_eval_phases(
        torch, test_clip, root, td_root, work, k, n_frames, reset, counts,
        check_pngs, pngs)
    td_counts.update(tdnet_nonlocal3d_train_phases(
        torch, train_root, work, k, steps, reset, counts))

    # m, n, o: HRNetV2 per-frame and hrnetv2_clip eval (exact, then
    # bucketed), the per-frame trainer with HRNetV2 and with OCRNet, and
    # the per-frame OCRNet eval
    hr_counts, hr_checks = hrnet_ocr_phases(
        torch, test_clip, root, train_root, work, k, n_frames, reset, counts,
        check_pngs, pngs)

    # p: the remaining per-frame baselines (UPerNet, DeepLab, Non-local 2D,
    # MobileNetV2, ResNeXt-101), eval (exact, then bucketed) and training
    base_counts, base_checks = baseline_phases(
        torch, root, train_root, work, k, n_frames, reset, counts)

    # q: the per-frame trainer's --resume after a real SIGTERM,
    # --usetwodata, --refrng and --profile_dir; r: demo.py; s: vc_perclip
    # over phase a's PNGs; t: test_clip --torch_load, exact and bucketed
    with deterministic_algorithms(torch):
        q_counts, q_checks = resume_phases(torch, work, k, hw, reset, counts)
    demo_counts, demo_check = demo_phase(torch, root, work, raft_ckpt,
                                         reset, counts)
    from cvpr2021_vspw_implement_tpu_torch import vc_perclip
    vc = vc_perclip.main(["--dataroot", root, "--predroot", preds,
                          "--clip_num", "8"])
    print(f"vc_perclip --clip_num 8 over phase a's PNGs: VC8 {vc:.6f} (the "
          f"raw masks; test_clip's VC {metrics['VC']:.6f} reads the "
          f"remapped labels)")
    if not 0 <= vc <= 1:
        raise SystemExit(f"vc_perclip: {vc}")
    tl_counts = torch_load_phase(torch, test_clip, root, work, k, preset,
                                 per_frame, n_frames, reset, counts, pngs,
                                 preds, preds_b)

    # the port's bench, quick: N = 4 frames, M = 2 windows, K = 2 steps,
    # P = 2 pairs, at full width and resolution; it prints its JSON line
    reset()
    t0 = time.perf_counter()
    bench_out = bench.main(["--quick"])
    bench_counts = counts()
    print(f"bench --quick: {time.perf_counter() - t0:.1f} s; kernel launches "
          f"{bench_counts}")
    check_bench(bench_out, per_frame, per_pair, bench.RAFT_ITERS, per_window,
                {**ocr_netwarp_band_launches(torch, raft),
                 "tdnet": tdnet_band_launches(torch),
                 "hrnet": hrnet_ocr_band_launches(torch)["hrnet"]})

    by_path = {"eval": eval_counts, "tc": tc_counts,
               "eval_bucketed": eval_b_counts, "tc_bucketed": tc_b_counts,
               "clip_psp": psp_counts, "etc": etc_counts, **train_counts,
               **window_counts, **frame_counts, **ocr_counts, **td_counts,
               **hr_counts, **base_counts, **q_counts, "demo": demo_counts,
               **tl_counts, "bench": bench_counts}
    for row in rows:
        row["launches_by_path"] = {path: c[row["name"]]
                                   for path, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["launches"] <= 0:
            raise SystemExit(f"{row['name']} was not launched on the main "
                             "path")
    # the lookup's two shapes: 1x60x107 on the TC and NetWarp eval paths,
    # 2x60x60 in the RAFT methods' train steps
    rows[0]["also_at"][0]["launches"] = etc_counts["corr_lookup"] + sum(
        ocr_counts["train_" + m]["corr_lookup"]
        for m in ("netwarp", "netwarp_ocr", "etc_ocr"))
    # B5's other shapes: their launches on the window CLI paths (the
    # bench's are in the row's total only)
    for row in rows:
        backward = row["name"].endswith("_backward")
        for a in row.get("also_at", ()) if backward else ():
            # our_warp_merge's Cd 256, or nearest's crowded inputs at the
            # shape of its train path
            a["launches"] = train_counts[
                "train_our_warp_merge" if a["shape"].startswith("merge")
                else "train_our_warp_nearest"][row["name"]]
        for a in row.get("also_at", ()) if row["name"].startswith(
                "local_") and not backward else ():
            merge, bucket = a["shape"].startswith("merge"), "valid" in a[
                "shape"]
            a["launches"] = sum(
                window_counts[p + ("_bucketed" if bucket else "")][
                    row["name"]]
                for p, method, _, _ in WINDOW_PATHS
                if (method == "our_warp_merge") == merge)

    # "shape" says where ms, bound and error were taken,
    # "also_at" holds the same numbers at a path's other shape, or (one
    # level) at the shape of the per-level variant
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "launches_by_path", "also_at", "rel_err",
            "weight_spread_q10_q50_q90", "excused_near_ties", "mismatches",
            "crop_gap", "crop_bitwise", "band_nonzero", "crop_ms",
            "picks_outside_image", "most_picks_of_a_key", "keys_picked",
            "two_slice_zero_ms", "profiler_ms", "enqueue_ms",
            "library_profiler_ms", "library_enqueue_ms",
            "two_slice_zero_profiler_ms", "two_slice_zero_enqueue_ms")

    def public(r):
        out = {key: r[key] for key in keys if key in r}
        if "also_at" in out:
            out["also_at"] = [public(a) for a in out["also_at"]]
        return out

    # the CUDA-core f32 bound of B2-B4 (67 TFLOP/s), beside bound_ms (the
    # 3xTF32 tensor-core one) of the kernels line
    simt = [{"name": r["name"], "shape": a["shape"],
             "bound_f32_simt_ms": a["bound_f32_simt_ms"]}
            for r in rows for a in (r, *r.get("also_at", ()))
            if "bound_f32_simt_ms" in a]
    # the bytes B6 writes and the 32-byte sectors B1 and B6 touch, with the
    # floor that whole sectors set, beside bound_ms of the kernels line
    floors = [{"name": r["name"], "shape": a["shape"], **a["floor"]}
              for r in rows for a in (r, *r.get("also_at", ()))
              if "floor" in a]
    # B1 read again after every path, beside the card's clocks then: an
    # unchanged kernel that reads slower with its plain version points at
    # the card, not the kernel
    clocks_last = smi_clocks()
    b1_again = check_corr_lookup(torch, *next(lookup_cases(torch)))
    b1_reread = {"first": {k: rows[0][k] for k in ("ms", "plain_ms")},
                 "again": {k: b1_again[k] for k in ("ms", "plain_ms")},
                 "clocks_first": clocks_first, "clocks_again": clocks_last}
    print(f"corr_lookup at 1x60x107 read again after the paths: kernel "
          f"{b1_again['ms']:.4f} ms, plain {b1_again['plain_ms']:.4f} ms "
          f"(first reading {rows[0]['ms']:.4f} and "
          f"{rows[0]['plain_ms']:.4f}); clocks {clocks_last}")
    print(json.dumps({"bucket_tax": tax, "bucketed_vs_exact": bucket_check,
                      "window_bucketed_vs_exact": window_checks,
                      "tc_check": tc_check, "native_host_ops": host_ops,
                      "frame_bucketed_vs_exact": frame_check,
                      "ocr_netwarp_bucketed_vs_exact": ocr_checks,
                      "tdnet_nonlocal3d_bucketed_vs_exact": td_checks,
                      "hrnet_ocrnet": hr_checks,
                      "frame_baselines": base_checks,
                      "frame_restart_flags": q_checks, "demo": demo_check,
                      "vc_perclip": vc,
                      "frame_train": frame_train, "loader": loader,
                      "b1_reread": b1_reread,
                      "update_block_routes": routes, "ptxas": ptxas,
                      "f32_simt_bounds": simt, "sector_floors": floors}))
    print(json.dumps({"kernels": [public(r) for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. prints the card (name, and name and power limit from nvidia-smi);
2. builds the CUDA kernels from ``kernels/csrc`` with nvcc (in parallel)
   and prints ptxas's registers, spills and shared memory of the
   tensor-core kernels;
3. holds each kernel against its plain PyTorch version at the main paths'
   shapes (corr lookup: TC at VSPW-480p, 60x107 RAFT features; GRU pass:
   60x107 and the 60x112 bucket;
   corr lookup, motion encoder and GRU + flow head: the 479 training crop,
   batch 2, 60x60; the three local aggregations of our_warp: 1x60x107,
   128-d distances, 256-d values, r = 10; the band re-zero: R101 features
   and C5 in the 480x896 bucket, a correlation-pyramid level, a rows-only
   and a no-band case, bitwise)
   with TF32 off, and times kernel, plain version, bound and the PyTorch
   yardstick; then times one refinement of RAFT's update block by its fused
   route (B2 + B3) and its unfused one (cuDNN + B4 + cuDNN) at 2x60x60 and
   1x60x107;
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
   b'. the TC metric at its default, bucketed, over a''s PNGs;
   c. the clip trainer (``train_clip``) on synthetic 480x853 videos, the same
      R101 preset, crop 479, batch 2: ``--method clip_psp`` (4 frames,
      offsets 3,6,9), then ``--method ETC`` (2 frames, RAFT at 20
      refinements), four steps each;
   d. our_warp window eval (``test_clip --method our_warp``, seeded random
      R101 ClipWarpNet, clip_num 4, max_distances 10) in each mode: sigmoid
      over the 10-frame video, ``--distsoftmax`` and ``--distnearest`` over
      a 5-frame one, each launching its kernel exactly 3 times a frame;
   e. ETC window eval (``test_clip --method ETC``) over the 5-frame video;
   (the window paths run exact shapes: ``--width_bucket 0``)
5. checks the outputs (PNG shapes and classes, finite mIoU, VC, TC and
   losses, moving head and encoder parameters, a frozen RAFT) and that the
   card and the CPU agree on small inputs, a train step and ClipWarpNet in
   its three modes included;
6. prints the kernels' JSON line and, last, the device JSON line.

It exits non-zero without CUDA, on any failed phase, or when run outside
a checkout of the repository.
"""

from __future__ import annotations

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


def check_corr_lookup(torch, g, b, h, w, levels=4):
    """The corr-lookup kernel vs plain on a [b, h, w] grid of queries with
    rows of far-out-of-range taps (limit 1e-5), over the first ``levels``
    levels of the pyramid; returns the error, the times and the bound at
    that shape."""
    from cvpr2021_vspw_implement_tpu_torch.models.raft.corr import \
        build_corr_pyramid
    from cvpr2021_vspw_implement_tpu_torch.models.raft.raft import \
        coords_grid
    from cvpr2021_vspw_implement_tpu_torch.ops.corr_lookup import (
        lookup_corr_pyramid, lookup_corr_pyramid_plain)

    shape = f"{b}x{h}x{w}" + ("" if levels == 4 else f", {levels} level")
    f1 = torch.randn(b, 256, h, w, device="cuda", generator=g)
    f2 = torch.randn(b, 256, h, w, device="cuda", generator=g)
    pyr = build_corr_pyramid(f1, f2)[:levels]
    coords = coords_grid(b, h, w, "cuda") + 8 * torch.randn(
        b, 2, h, w, device="cuda", generator=g)
    coords[:, 0, :3] = -20.0                   # rows of far-out-of-range taps
    coords[:, 1, -3:] = h + 15.5
    coords = coords.contiguous()
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
    row = {
        "shape": shape, "max_abs_err": err,
        "plain_ms": cuda_ms(lambda: lookup_corr_pyramid_plain(pyr, coords)),
        "ms": cuda_ms(lambda: lookup_corr_pyramid(pyr, coords)),
        "library_ms": cuda_ms(lambda: grid_sample_lookup(pyr, coords)),
    }
    t_bytes = lookup_bytes(pyr, coords) / HBM_BYTES_PER_S
    # 4 taps a window position: weights and blend
    t_ops = 11 * 4 * 81 * levels * b * h * w / F32_FLOP_PER_S
    row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return row


def check_kernels(torch):
    """Each kernel vs plain at the shapes the paths give it; returns the
    kernels' JSON rows (launches filled in later)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    # both shapes the paths give the lookup: TC at 480x853 (one pair) and
    # the ETC train step (the 479 crop padded to 480, batch 2)
    at_tc = check_corr_lookup(torch, g, 1, 60, 107)
    at_train = check_corr_lookup(torch, g, 2, 60, 60)
    # the per-level variant of the TPU kernel (_lookup_level_pallas, corr.py
    # :186) is this kernel with one level; no path launches it alone
    one_level = check_corr_lookup(torch, g, 1, 60, 107, levels=1)
    one_level["launches"] = 0
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
              {"name": "sep_gru", **k2["also_at"][0]}]:
        simt = (f", f32 CUDA-core bound {k['bound_f32_simt_ms']:.4f} ms"
                if "bound_f32_simt_ms" in k else "")
        print(f"{k['name']} at {k['shape']}: kernel {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.4f} ms, library {k['library_ms']:.4f} ms, "
              f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}){simt}")
    return rows


def tensor_core_bound(row, flops, nbytes):
    """The bounds of a kernel of f32 convolutions (B2-B4): ``bound_ms`` at
    the f32-accurate tensor-core rate (3xTF32, 165 TFLOP/s), and
    ``bound_f32_simt_ms`` at the CUDA cores' f32 rate, either against the
    bytes.  The second is printed and goes to the extra JSON line, not to
    the kernels line."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / TF32X3_FLOP_PER_S
    row["bound_ms"] = 1e3 * max(t_ops, t_bytes)
    row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    row["bound_f32_simt_ms"] = 1e3 * max(flops / F32_FLOP_PER_S, t_bytes)


def check_sep_gru(torch, g, h, w):
    """The GRU-pass kernel vs plain at 1 x h x w (hd 128, cx 256), both
    axes (limit 1e-4); returns its numbers per pass, the mean of the axes."""
    from cvpr2021_vspw_implement_tpu_torch.ops.sep_gru import (
        sep_conv_gru_pass, sep_conv_gru_pass_plain)

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
        row, 2 * p * 5 * (hd + cx) * 3 * hd,
        4 * (p * (hd + cx + hd) + 5 * (hd + cx) * 3 * hd + 3 * hd))
    return row


def ptxas_lines(log):
    """``ptxas -v`` lines of the tensor-core kernels in an nvcc log: each
    kernel's mangled name (which carries its tap shape and epilogue),
    registers, spills and static shared memory."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and "tap_mma_kernel" in name and (
                "registers" in line or "spill" in line):
            out.append(f"{name}: {line.strip()}")
    return out


def check_update_kernels(torch, g):
    """The fused update-block kernels vs plain at the training shape (crop
    479 pads to 480: 60x60 features, batch 2); returns their JSON rows."""
    from cvpr2021_vspw_implement_tpu_torch.ops.gru_flowhead import (
        gru_flowhead, gru_flowhead_plain)
    from cvpr2021_vspw_implement_tpu_torch.ops.motion_encoder import (
        motion_encoder, motion_encoder_plain)

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
    tensor_core_bound(k3, 2 * b * p * (ck * 256 + 9 * 256 * 192 + 98 * 128 + 9 * 128 * 64
                           + 9 * 256 * 126),
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
    tensor_core_bound(k4, 2 * b * p * (2 * 5 * cin * 3 * hd + 9 * hd * cf + 9 * cf * 2),
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


def check_local_agg(torch):
    """The three local-aggregation kernels vs plain at our_warp's eval shape
    (R101 at 480x853: 1x60x107 features, 128-d distance embedding, 256-d
    values, r = 10, temp 3); returns their JSON rows.  The inputs make the
    window weights far from uniform: y_dist is the N(0, 0.05^2) x shifted by
    one pixel down and one left, plus noise whose squared norm at each pixel
    lies in [0.01, 0.1], so the match's softmax score is 3.3 to 33 against
    about 0.5 elsewhere, far from the pole of 1 / (dist * 3 + 1e-5).
    Sigmoid and softmax: max abs error at most 1e-4 and at most 1e-4 of the
    largest output.  Nearest: the positions whose two largest in-image
    window distances lie within 1e-4 relative are excused (rounding may flip
    the argmax there); every other position must be equal."""
    from cvpr2021_vspw_implement_tpu_torch.ops import local_agg
    from cvpr2021_vspw_implement_tpu_torch.ops.local_pairwise import \
        local_pairwise_dist

    b, cd, cv, h, w, r, temp = 1, 128, 256, 60, 107, 10, 3.0
    p, kk = h * w, (2 * r + 1) ** 2
    g = torch.Generator(device="cuda").manual_seed(5)
    x = 0.05 * torch.randn(b, cd, h, w, device="cuda", generator=g)
    sq = 10.0 ** (torch.rand(b, 1, h, w, device="cuda", generator=g) - 2.0)
    yd = torch.roll(x, (1, -1), (2, 3)) + (sq / cd).sqrt() * torch.randn(
        b, cd, h, w, device="cuda", generator=g)
    yv = torch.randn(b, cv, h, w, device="cuda", generator=g)
    dist = local_pairwise_dist(x, yd, r)
    tie = near_ties(dist)
    rows = []
    for mode in ("sigmoid", "softmax", "nearest"):
        fn = getattr(local_agg, f"local_{mode}_aggregate")
        plain = getattr(local_agg, f"local_{mode}_aggregate_plain")
        kw = {"temp": temp} if mode == "softmax" else {}
        got = fn(x, yd, yv, r, **kw)
        torch.cuda.synchronize()
        want = plain(x, yd, yv, r, **kw)
        lib_err = (unfold_local_agg(x, yd, yv, r, mode, temp)
                   - want).abs().max().item()
        err = (got - want).abs().max().item()
        row = {"name": f"local_{mode}_aggregate", "route": "cuda",
               "source": "cvpr2021_vspw_implement_tpu_torch/kernels/csrc/"
                         "local_agg.cu",
               "replaces": "cvpr2021_vspw_implement_tpu/ops/pallas/"
                           "local_agg.py:" + {"sigmoid": "229",
                                              "softmax": "121",
                                              "nearest": "197"}[mode],
               "shape": f"{b}x{h}x{w}, Cd {cd}, Cv {cv}, r {r}",
               "max_abs_err": err}
        if mode == "nearest":
            differ = (got != want).any(1)
            bad = int((differ & ~tie).sum().item())
            row["excused_near_ties"] = int(tie.sum().item())
            row["mismatches"] = bad
            picks_in = int((dist.flatten(1, 2).max(1).values < 1e19).sum()
                           .item())
            print(f"local_nearest_aggregate: {bad} mismatching positions of "
                  f"{p} after excusing {row['excused_near_ties']} near-ties "
                  f"(max abs error {err:.3e}, out-of-image picks "
                  f"{p - picks_in}); |unfold - plain| = {lib_err:.3e}")
            ok = bad == 0
            flops = 2 * b * p * kk * cd
            nbytes = 4 * (b * p * (2 * cd + cv) + picks_in * cv)
        else:
            q = weight_spread(torch, dist, mode, temp)
            scale = want.abs().max().item()
            row["rel_err"] = err / scale
            row["weight_spread_q10_q50_q90"] = q
            print(f"local_{mode}_aggregate: max |kernel - plain| = "
                  f"{err:.3e} = {row['rel_err']:.3e} of max |plain| "
                  f"{scale:.3e} (limits 1e-4 and 1e-4 of max |plain|); "
                  f"largest over mean window weight, quantiles 0.1/0.5/0.9 "
                  f"over positions: {q[0]:.4g}/{q[1]:.4g}/{q[2]:.4g} (1 if "
                  f"uniform, {kk} at most); |unfold - plain| = "
                  f"{lib_err:.3e}")
            ok = err <= 1e-4 and err <= 1e-4 * scale
            flops = 2 * b * p * kk * (cd + cv)
            nbytes = 4 * b * p * (2 * cd + 2 * cv)
        if not ok:
            raise SystemExit(f"local_{mode}_aggregate kernel disagrees with "
                             "its plain version")
        row["plain_ms"] = cuda_ms(lambda: plain(x, yd, yv, r, **kw), n=5)
        row["ms"] = cuda_ms(lambda: fn(x, yd, yv, r, **kw))
        row["library_ms"] = cuda_ms(
            lambda: unfold_local_agg(x, yd, yv, r, mode, temp), n=5)
        t_ops, t_bytes = flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        row["bound_ms"] = 1e3 * max(t_ops, t_bytes)
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        rows.append(row)
    return rows


def check_band_zero(torch):
    """The band re-zero kernel vs plain, bitwise, at the shapes bucketed eval
    gives it (R101 at 480x853 in the 480x896 bucket: a 256-channel feature
    and C5 at 60x112, valid 60x107; a correlation-pyramid level of the TC
    pair, [6720, 1, 30, 56], valid 30x53), a rows-only case and a no-band
    case (no launch).  Each is timed beside the plain version, the two-slice
    ``zero_()`` and the JAX formulation ``torch.where`` over the whole
    tensor; the bound is the bytes written over the memory rate.  Returns
    the kernel's JSON row (at C5, the others under ``also_at``)."""
    from cvpr2021_vspw_implement_tpu_torch.ops.band_zero import (
        band_zero, band_zero_plain)

    g = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for label, shape, hv, wv in (
            ("C5", (1, 2048, 60, 112), 60, 107),
            ("feature", (1, 256, 60, 112), 60, 107),
            ("pyramid level", (6720, 1, 30, 56), 30, 53),
            ("rows only", (1, 256, 64, 112), 57, 112),
            ("no band", (1, 256, 60, 112), 60, 112)):
        x = torch.randn(*shape, device="cuda", generator=g)
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
               "ms": cuda_ms(lambda: band_zero(x, hv, wv)),
               "plain_ms": cuda_ms(lambda: band_zero_plain(x, hv, wv)),
               "two_slice_zero_ms": cuda_ms(two_slices),
               "library_ms": cuda_ms(lambda: torch.where(mask, x, 0.0)),
               "bytes_written": 4 * band,
               "bound_ms": 1e3 * 4 * band / HBM_BYTES_PER_S,
               "bound_by": "bytes"}
        print(f"band_zero at {label}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, two-slice zero_ "
              f"{row['two_slice_zero_ms']:.4f} ms, torch.where over the "
              f"tensor {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['bytes_written']} bytes "
              "written)")
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
    near-ties); logits within 1e-4 of their range."""
    from cvpr2021_vspw_implement_tpu_torch.models.layers import init_weights
    from cvpr2021_vspw_implement_tpu_torch.models.resnet import build_encoder
    from cvpr2021_vspw_implement_tpu_torch.models.warp_our import (
        ClipWarpNet, warp_one_scale)
    from cvpr2021_vspw_implement_tpu_torch.ops.local_pairwise import \
        local_pairwise_dist

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
        print(f"ClipWarpNet ({mode}): aggregations kernel vs plain on the "
              f"model's embeddings, {agg}; logits card vs CPU, max |diff| / "
              f"range = {rel:.3e} (limits 1e-4)")
        if not (err <= 1e-4 and rel <= 1e-4):
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


def train_phase(torch, method, flags, root, work, preset, k, steps):
    """``steps`` steps of ``train_clip.main`` at full width; prints step
    times, losses and peak memory and returns the model.  Fails unless the
    losses are finite, a head and an encoder parameter moved and RAFT did
    not."""
    from cvpr2021_vspw_implement_tpu_torch import train_clip

    records, before = [], {}
    step = train_clip.train_step

    def watched(model):
        named = dict(model.named_parameters())
        names = [n for n in named if n.startswith("encoder.")][:1]
        names += [n for n in named if n.endswith(".4.weight")][:1]
        names += [n for n in named if n.startswith("raft.")][:1]
        return {n: named[n] for n in names}

    def timed_step(model, *args):
        if not before:
            before.update({n: p.detach().clone()
                           for n, p in watched(model).items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(model, *args)
        torch.cuda.synchronize()
        records.append((time.perf_counter() - t0, float(metrics["loss"])))
        return metrics

    torch.cuda.reset_peak_memory_stats()
    train_clip.train_step = timed_step
    try:
        model = train_clip.main([
            "--cfg", preset, "--dataroot", root, "--num_class", str(k),
            "--method", method, *flags, "--batchsize", "2", "--cropsize",
            "479", "--lr", "0.002", "--totalepoch", str(steps // 2),
            "--saveroot", os.path.join(work, "ckpt_" + method), "--seed", "0",
            "DIR", os.path.join(work, "cfg_" + method)])
    finally:
        train_clip.train_step = step
    peak = torch.cuda.max_memory_allocated()
    times = [t for t, _ in records]
    losses = [loss for _, loss in records]
    if len(records) != steps or not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"{method}: {len(records)} steps, losses {losses}")
    for name, p in watched(model).items():
        moved = not torch.equal(p.detach(), before[name])
        if moved == name.startswith("raft."):
            raise SystemExit(f"{method}: parameter {name} "
                             f"{'moved' if moved else 'did not move'}")
    print(f"train {method} (R101, crop 479, batch 2, f32): first step "
          f"{1e3 * times[0]:.1f} ms, then "
          f"{1e3 * sum(times[1:]) / (steps - 1):.1f} ms/step over "
          f"{steps - 1} steps; losses {[round(v, 4) for v in losses]}; "
          f"peak memory {peak / 2 ** 30:.2f} GiB")
    return model


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
    from cvpr2021_vspw_implement_tpu_torch.ops import local_agg
    from cvpr2021_vspw_implement_tpu_torch.ops.gru_flowhead import \
        gru_flowhead
    from cvpr2021_vspw_implement_tpu_torch.ops.motion_encoder import \
        motion_encoder
    from cvpr2021_vspw_implement_tpu_torch.ops.sep_gru import \
        sep_conv_gru_pass
    from cvpr2021_vspw_implement_tpu_torch.ops.band_zero import band_zero

    wrappers = {"corr_lookup": lookup_corr_pyramid,
                "sep_gru": sep_conv_gru_pass,
                "motion_encoder": motion_encoder,
                "gru_flowhead": gru_flowhead,
                **{f"local_{m}_aggregate":
                   getattr(local_agg, f"local_{m}_aggregate")
                   for m in ("sigmoid", "softmax", "nearest")},
                "band_zero": band_zero}
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
    ptxas = [line for name in ("sep_gru", "gru_flowhead")
             for line in ptxas_lines(logs.get(name, ""))]
    for line in ptxas:
        print(f"ptxas: {line}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = check_kernels(torch)
    routes = update_block_routes(torch)
    small_input_agreement(torch)
    clip_warp_agreement(torch)
    train_step_agreement(torch)

    work = os.path.join(REPO, "build", "chip_smoke")
    root, preds = os.path.join(work, "vspw"), os.path.join(work, "preds")
    n_frames, hw, k = 10, (480, 853), 124
    make_synthetic_vspw(root, 1, n_frames, hw, k, seed=0)
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

    # RAFT of both TC phases: the seeded init with the flow head scaled by
    # 0.1, a trained-like step (the random init moves the flow ~20 px a
    # refinement, and each refinement then amplifies f32 rounding ~8x)
    iters, pairs = 20, n_frames - 1
    raft = tc_cal.build_raft(tc_cal.build_parser().parse_args(
        ["--dataroot", root, "--predroot", preds, "--allow_random_raft",
         "--raft_iters", str(iters), "--seed", "0"]), "cpu")
    with torch.no_grad():
        raft.update_block.flow_head.conv2.weight.mul_(0.1)
        raft.update_block.flow_head.conv2.bias.mul_(0.1)
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
    # conv, the low-resolution flow, and the full-resolution flow in tc_cal.
    # At 480x853 in the 480x896 bucket every one of them has a band.
    def spatial_convs(module):
        return sum(isinstance(m, torch.nn.Conv2d) and max(m.kernel_size) > 1
                   for m in module.modules())

    from cvpr2021_vspw_implement_tpu_torch.models.resnet import build_encoder
    per_frame = spatial_convs(build_encoder("resnet101dilated")) + 3
    ub = raft.update_block
    per_pair = (spatial_convs(raft.fnet) + spatial_convs(raft.cnet)
                + raft.corr_levels
                + iters * (spatial_convs(ub.encoder)
                           + spatial_convs(ub.flow_head) + 4)
                + spatial_convs(ub.mask) + 2)
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
          f"{tc:.6f}, |diff| {abs(tc_b - tc):.3e}, limit 1e-3); band_zero "
          f"{tc_b_counts['band_zero'] / pairs:g} launches a pair (derived "
          f"{per_pair}); kernel launches {tc_b_counts}")
    for name, n in tc_b_counts.items():
        want = {"corr_lookup": 20, "sep_gru": 40,
                "band_zero": per_pair}.get(name, 0) * pairs
        if n != want:
            raise SystemExit(f"{name}: {n} launches in the bucketed TC, "
                             f"expected {want}")
    if not abs(tc_b - tc) <= 1e-3:
        raise SystemExit("bucketed TC disagrees with exact TC")

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

    # the window eval path: our_warp in its three modes (the main video for
    # the default mode, a 5-frame one for the other two), then ETC
    short_root = os.path.join(work, "vspw_short")
    make_synthetic_vspw(short_root, 1, 5, hw, k, seed=2)
    window_counts = {}
    for path, flags, root_v, n_v in (
            ("our_warp", [], root, n_frames),
            ("our_warp_softmax", ["--distsoftmax", "true"], short_root, 5),
            ("our_warp_nearest", ["--distnearest", "true"], short_root, 5),
            ("etc_eval", ["--clip_num", "2"], short_root, 5)):
        method = "ETC" if path == "etc_eval" else "our_warp"
        out_dir = os.path.join(work, "preds_" + path)
        reset()
        t0 = time.perf_counter()
        m, _ = test_clip.main([
            "--cfg", preset, "--dataroot", root_v, "--num_class", str(k),
            "--method", method, *flags, "--vc_clip_num", "4",
            "--width_bucket", "0", "--is_save", "--saveroot", out_dir,
            "--seed", "0"])
        secs = time.perf_counter() - t0
        window_counts[path] = c = counts()
        print(f"{path} window eval (R101, 480x853, {n_v} frames): "
              f"{1e3 * secs / n_v:.1f} ms/frame including the first frame "
              f"and model set-up; per window (evaluate_clip's frame times: "
              f"decode, forward, argmax) {m['first_frame_ms']:.1f} ms for "
              f"the first, then {m['frame_ms']:.1f} ms; mIoU "
              f"{m['mIoU']:.6f} VC {m['VC']:.6f}; kernel launches {c}")
        mode = {"our_warp": "sigmoid", "our_warp_softmax": "softmax",
                "our_warp_nearest": "nearest"}.get(path)
        for name, n in c.items():
            want = 3 * n_v if name == f"local_{mode}_aggregate" else 0
            if n != want:
                raise SystemExit(f"{name}: {n} launches on the {path} path, "
                                 f"expected {want}")
        check_pngs(os.path.join(out_dir, "video_000"), n_v)
        if not (np.isfinite(m["mIoU"]) and np.isfinite(m["VC"])):
            raise SystemExit(f"{path}: non-finite metric")

    by_path = {"eval": eval_counts, "tc": tc_counts,
               "eval_bucketed": eval_b_counts, "tc_bucketed": tc_b_counts,
               "clip_psp": psp_counts, "etc": etc_counts, **window_counts}
    for row in rows:
        row["launches_by_path"] = {path: c[row["name"]]
                                   for path, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["launches"] <= 0:
            raise SystemExit(f"{row['name']} was not launched on the main "
                             "path")
    # the lookup's two shapes: 1x60x107 on the TC path, 2x60x60 in ETC
    rows[0]["also_at"][0]["launches"] = etc_counts["corr_lookup"]

    # "shape" says where ms, bound and error were taken,
    # "also_at" holds the same numbers at a path's other shape, or (one
    # level) at the shape of the per-level variant
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "launches_by_path", "also_at", "rel_err",
            "weight_spread_q10_q50_q90", "excused_near_ties", "mismatches",
            "two_slice_zero_ms", "bytes_written")

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
    print(json.dumps({"bucket_tax": tax, "bucketed_vs_exact": bucket_check,
                      "update_block_routes": routes, "ptxas": ptxas,
                      "f32_simt_bounds": simt}))
    print(json.dumps({"kernels": [public(r) for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

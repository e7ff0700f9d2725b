"""The port's benchmark: every ported path, steady state, on one card
(JAX counterpart: the root ``bench.py``).

    python -m cvpr2021_vspw_implement_tpu_torch.bench             # the card
    python -m cvpr2021_vspw_implement_tpu_torch.bench --quick     # 4, 2, 2, 2
    python -m cvpr2021_vspw_implement_tpu_torch.bench --device cpu \
        --toy --quick                                   # the CPU test's run

Prints ONE JSON line with the JAX bench's key names where a row has a
counterpart.  The model is the JAX bench's: ResNet-101-dilated TCB-PSP,
fc_dim 2048, 124 classes, at VSPW-480p (480x853), seeded random weights
(``models/layers.py::init_weights``), f32 with TF32 off in cuDNN and
matmuls, as the port's CLIs run.  Every timed step takes its own input,
made on the device before the clock starts.  The rows:

* ``value`` (frames/s), ``mfu``: TCB-PSP streaming at exact shapes over N
  frames; a frame is what ``serving.py::ExactShapeEngine`` runs
  (``encode_frame`` on a permuted HWC view, the blend with the previous
  frame's pooled stats, ``fuse_target``, upsample and argmax);
  ``stream4_frames_per_sec`` the same for 4 videos batched;
  ``stream_bucketed_*`` the same as ``ClipPSPBucketEngine`` runs it (the
  480x896 bucket, the masked trunk: B6);
* ``baseline_*``: the reference window formulation, ``ClipPSP.forward``
  over M windows of 4 frames, the denominator of ``vs_baseline``;
* ``train_*``: ``parallel/train_state.py::train_step`` with
  ``clip_psp_loss``, 4 frames x batch 2 x crop 479, K steps back to back
  with one synchronise (the step returns detached 0-d tensors), and one
  step with its own readback; ``etc_train_*`` the same for ETC (2 frames,
  K' steps, RAFT at 20 refinements: B1, B2, B3); ``our_warp_train_*`` the
  same for our_warp (``clip_warp_loss`` with ``allsup``, 4 frames, r = 10,
  sigmoid: 3 B5 forward and 3 B5 backward launches a step); the JAX bench
  has no such row, the key is the port's own;
* ``etc_windows_per_sec``, ``our_warp_windows_per_sec``,
  ``propnet_windows_per_sec``, ``our_warp_merge_windows_per_sec``: the
  window forward of ``test_clip --method ETC`` / ``our_warp`` /
  ``propnet`` / ``our_warp_merge`` (``test_clip.window_pred``: the model,
  upsample and argmax; ETC 2 frames, the others clip_num 4 and r = 10,
  sigmoid: our_warp 3 B5 a window, our_warp_merge 1) over M windows at
  exact shapes; ``etc_bucketed_windows_per_sec`` and
  ``our_warp_bucketed_windows_per_sec`` the same in the 480x896 bucket as
  the CLI's default runs it (the window padded in the step, as
  ``stream_bucketed`` pads its frame; the masked model: B6, and B5 with the
  valid size 60x107 on the 60x112 grid).  The JAX bench has no
  ``our_warp_bucketed`` row: that key is the port's own;
* ``tc_ms_per_pair``, ``tc_bucketed_ms_per_pair``: ``tc_cal.run_pair`` over
  P pairs, RAFT at 20 refinements with the flow head scaled by 0.1 (a
  trained-like step, as chip_smoke.py's TC), exact (B1, B4) and bucketed
  (B1, B4, B6);
* ``clipocr_*``: TCB-OCR (ResNet-101-dilated ``ClipOCRNet``) streaming
  with one carried context, as the JAX bench (bench.py:604-677): a frame is
  ``encode_frame``, the mean of its region context and the previous one's,
  ``fuse_target``, upsample and argmax, over N frames; exact, 4 videos
  batched, and bucketed as ``ClipOCRBucketEngine`` runs it (B6);
* ``netwarp_stream_*``: NetWarp streaming (JAX bench.py:850-915): a frame
  is its ``encode_frame`` and ``fuse_pair`` against the previous frame's
  cache (RAFT at 20 refinements, B1 and B4), over N frames, exact and
  bucketed as ``NetWarpBucketEngine`` runs it (B6 too);
  ``netwarp_train_*`` NetWarp's train step, 2 frames x batch 2 x crop 479,
  K' steps (B1, B2, B3);
* ``tdnet_*``: TDNet streaming (JAX bench.py:680-785), four seeded
  ResNet-18-dilated paths (crop 479's LayerNorm maps), over N frames with
  ``pos_id = frame % 4`` and the K/V/Q carry, which starts warm (three
  frames of zeros in it, so that every timed frame runs its attention, as
  in a video's steady state); a frame is ``TD4PSP.stream``, upsample
  (``align_corners=True``) and argmax, as ``serving.TDNetStreamer`` runs it:
  exact, 4 videos batched (``tdnet_stream4``) and bucketed in 480x896 (B6);
  ``tdnet_bucketed_overhead_pct`` derived as the JAX bench derives it;
* ``nonlocal3d_*``: Non-local 3D (ResNet-101-dilated ``NonLocal3D``) over
  M windows of 3 frames at exact shapes (JAX bench.py:917-960): a window is
  what ``test_clip``'s ``test_all`` runs for it in steady state, the model
  and each frame's upsampled probabilities (``test_clip.window_probs``),
  their sum into one frame's accumulator and that frame's argmax
  (``test_clip.frame_pred``);
* ``hrnet_*``: the per-frame HRNetV2-W48 + C1 (``vsp-hrnetv2.yaml``,
  fc_dim 720) over N frames as ``test.frame_pred`` runs one (the model,
  upsample and argmax of a contiguous NCHW frame): exact, and bucketed in
  480x896 (the masked trunk, its fusion upsamples at the true sizes: B6 at
  the input of each of its 265 spatial convs, its output and C1's input);
  ``hrnet_bucketed_overhead_pct`` derived as the TCB rows'; these keys are
  the port's own;
* ``hrnetclip_windows_per_sec``: ``hrnetv2_clip`` (HRNetV2Clip + C1), the
  window forward of ``test_clip --method hrnetv2_clip --clip_num 4``
  (``test_clip.window_pred``: 3 context frames through the frozen stem,
  the target's stem, TimeAtten, the stages, C1, upsample and argmax) over M
  windows at exact shapes; the port's own key;
* ``ocr_head_ms``: the JAX bench's OCR-head microbench (JAX
  bench.py:975-1012, the reference's harness shape, spatial_ocr_block.py:
  470-517): a 3x3 conv 2048 -> 512, ``spatial_gather`` with 19-class
  logits and ``SpatialOCR(512, 256, 512)`` at 128x128, batch 1, a call's
  ms over N calls; JAX runs it in bfloat16, the port in float32;
* ``host_decode_frames_per_sec``: 32 frames of the configuration's size,
  JPEGs that ``make_synthetic_vspw`` wrote, decoded by PIL and normalized
  by ``native.normalize_u8`` on one thread (host clock, best of 3), the
  work of the trainers' loader worker; ``host_decode_path`` names it.  The
  JAX bench (bench.py:1015-1050) decodes on a libjpeg thread pool over
  every core, which the port does not have.  ``host_cores_to_saturate_chip``:
  the streaming rate (``value``) over this one-thread rate, rounded up.

Each device row is timed by CUDA events around its whole loop, after a
warm-up step (the first call of a shape builds the kernels and picks
cuDNN's engines): the best of 3 trials, and the spread, worst over best
minus one, in ``spreads_pct``.  An ``mfu`` is the loop's operations over
its time and the card's f32 peak outside the tensor cores (the port
computes in f32): the PyTorch ops of one step counted by ``FlopCounterMode``
and each hand-written kernel's launches by its wrapper's own count
(``ops/*.py``: the kernels launch through ``ctypes``, out of the counter's
sight; B5 over the padded grid when bucketed), times the steps.  The
counter counts products and convolutions, not elementwise ops: propnet's
window distances, elementwise in the plain formulation, are outside its
``mfu``.  A card not in ``PEAK_F32_FLOPS`` is refused; on
the CPU the ``mfu`` fields are null and the times are the host clock's.
``flops`` gives each row's operations in one trial and ``launches`` its
kernel launches, from the wrappers' counters.  A row that fails fails the
run.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import tempfile
import time
from functools import partial

import numpy as np
import torch
from PIL import Image
from torch.utils.flop_counter import FlopCounterMode

from . import methods, native, tc_cal, test_clip
from . import test as frame_test
from .config import cfg as default_cfg
from .data import make_synthetic_vspw
from .models.clip_ocr import ClipOCRNet
from .models.clip_psp import ClipPSP, clip_psp_loss
from .models.etc import ETC, etc_loss
from .models.netwarp import NetWarp, netwarp_loss
from .models.layers import Conv
from .models.nonlocal3d import NonLocal3D
from .models.ocr import SpatialOCR, spatial_gather
from .models.propnet import PropNet
from .models.layers import init_weights, set_dropout_generator
from .models.raft import RAFT
from .models.resnet import build_encoder
from .models.segmentation import inference_pred, inference_pred_rt
from .models.td4_psp import TD4PSP, init_td4_state, td4_tokens
from .models.warp_our import ClipWarpNet, clip_warp_loss
from .models.warp_our_merge import OurWarpMerge
from .ops import local_agg
from .ops.band_zero import band_zero
from .ops.corr_lookup import lookup_corr_pyramid
from .ops.gru_flowhead import gru_flowhead
from .ops.masked import bucket_hw, feature_valid, pad_to
from .ops.motion_encoder import motion_encoder
from .ops.sep_gru import sep_conv_gru_pass
from .parallel import create_clip_optimizer, train_step
from .utils import resolve_device

PRESETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config",
                       "presets")
#: the JAX bench's model at VSPW-480p, and a toy of it for the CPU test
CONFIGS = {
    "full": {"preset": "vsp-resnet101dilated-ppm_deepsup_clip.yaml",
             "num_class": 124, "hw": (480, 853), "crop": 479, "ocr_hw": 128},
    "toy": {"preset": "vsp-resnet18dilated-ppm_deepsup_clip.yaml",
            "num_class": 5, "hw": (64, 96), "crop": 63, "ocr_hw": 16},
}
#: HRNet's presets (W48's widths are fixed: the toy runs them too)
HRNET_PRESETS = {"hrnet": "vsp-hrnetv2.yaml",
                 "hrnetclip": "vsp-hrnetv2_clip.yaml"}
#: N streaming frames, M windows, K train steps (clip_psp, our_warp), K'
#: (ETC, NetWarp), P TC pairs
COUNTS = {
    "full": {"frames": 64, "windows": 16, "train_steps": 8,
             "etc_train_steps": 4, "pairs": 8},
    "quick": {"frames": 4, "windows": 2, "train_steps": 2,
              "etc_train_steps": 2, "pairs": 2},
}
#: f32 FLOP/s outside the tensor cores, by the name the card reports
PEAK_F32_FLOPS = {"NVIDIA H100 80GB HBM3": 67e12}
RAFT_ITERS = 20
WIDTH_BUCKET = 64
TRIALS = 3
#: rows of the JAX bench the port cannot run yet
NOT_PORTED = [
    "int8_stream_frames_per_sec", "int8_speedup",
    "eval_policy_exact_mix_fps", "eval_policy_bucketed_mix_fps",
    "train_b4_ms_per_2_samples",
]


#: the hand-written kernels' wrappers by name; each counts its launches
#: (``launches``) and their f32 operations (``flops``; B6 does none)
WRAPPERS = {"corr_lookup": lookup_corr_pyramid,
            "sep_gru": sep_conv_gru_pass,
            "motion_encoder": motion_encoder,
            "gru_flowhead": gru_flowhead,
            **{f"local_{m}_aggregate{d}":
               getattr(local_agg, f"local_{m}_aggregate{d}")
               for d in ("", "_backward")
               for m in ("sigmoid", "softmax", "nearest")},
            "band_zero": band_zero}


def _counters():
    return {n: (fn.launches, getattr(fn, "flops", 0))
            for n, fn in WRAPPERS.items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Row:
    """One row's step, ``n`` steps a trial: ``step(i)`` does step i and
    returns a tensor that depends on its output."""

    def __init__(self, device, step, n: int):
        self.device, self.step, self.n = device, step, n

    def loop(self):
        return sum(self.step(i).sum() for i in range(self.n))

    def measure(self) -> dict:
        """Warm-up step, one step counted, then the timed trials: best and
        spread of the loop's seconds, its operations (None on the CPU) and
        its kernel launches in one trial."""
        self.step(0)
        _sync(self.device)
        before = _counters()
        with FlopCounterMode(display=False) as fc:
            self.step(0)
        after = _counters()
        flops = fc.get_total_flops() + sum(after[k][1] - before[k][1]
                                           for k in after)
        before = _counters()
        seconds = [self._trial() for _ in range(TRIALS)]
        after = _counters()
        return {"seconds": min(seconds),
                "spread_pct": 100.0 * (max(seconds) / min(seconds) - 1.0),
                "flops": flops * self.n,
                "launches": {k: (after[k][0] - before[k][0]) // TRIALS
                             for k in after}}

    def _trial(self) -> float:
        """Seconds of one loop: CUDA events around it on the card (the end
        event waits for the device), the host clock on the CPU."""
        _sync(self.device)
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            out = self.loop()
            seconds = time.perf_counter() - t0
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.loop()
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        if not torch.isfinite(out.float()).all():
            raise RuntimeError("a timed loop gave a non-finite result")
        return seconds


def _model(cls, cfg, num_class: int, device, **kw):
    model = cls(build_encoder(cfg.MODEL.arch_encoder), num_class,
                fc_dim=cfg.MODEL.fc_dim, **kw)
    init_weights(model, torch.Generator().manual_seed(0))
    return model.to(device)


def _checksum(pred):
    return pred[:, ::97, ::97].sum()


def _stream_row(frame, state, conf, n: int, batch: int, device, gen,
                contiguous: bool = False) -> dict:
    """``frame(img, state) -> (state, pred)`` over n random frames of
    ``batch`` videos, each step's state carried to the next."""
    h, w = conf["hw"]
    frames = torch.randn(n, batch, h, w, 3, device=device, generator=gen)
    carry = [state]

    def step(i):
        # one frame as the exact engine views it, [H, W, 3] permuted then
        # unsqueezed: a batch stride of 3, which PyTorch reads as NCHW.  A
        # permuted [B, H, W, 3] slice has the strides of channels-last, and
        # cuDNN then runs the trunk in NHWC: so the 4 batched videos (no
        # engine batches them).  NetWarp's engine makes the frame
        # contiguous (``contiguous``): RAFT's kernels read it
        img = (frames[i, 0].permute(2, 0, 1)[None] if batch == 1
               else frames[i].permute(0, 3, 1, 2))
        carry[0], pred = frame(img.contiguous() if contiguous else img,
                               carry[0])
        return _checksum(pred)

    row = Row(device, step, n).measure()
    row["per_second"] = n * batch / row["seconds"]
    return row


def _pred(logits, key, fv, hw, align_corners: bool = False):
    """Upsample and argmax as the engines do: at the frame's size, or
    bucketed (``fv`` the logits' valid size) on the bucket grid, cropped."""
    if fv is None:
        return inference_pred(logits, hw, align_corners=align_corners)
    return inference_pred_rt(logits, key, fv, hw,
                             align_corners=align_corners)[:, :hw[0], :hw[1]]


def stream_rows(model, fc_dim: int, conf, counts, device, gen, out):
    """TCB-PSP streaming: exact, 4 videos, bucketed."""
    h, w = conf["hw"]
    key = bucket_hw(h, w, WIDTH_BUCKET)

    @torch.inference_mode()
    def frame(img, prev, bucketed):
        """One frame as the engines run it: img a [B, 3, H, W] view of HWC
        frames (the bucket engine pads it to contiguous NCHW)."""
        if bucketed:
            c5, pooled = model.encode_frame(pad_to(img, key), valid_hw=(h, w))
            fv = feature_valid(c5.shape[2], c5.shape[3], (h, w), key)
        else:
            c5, pooled = model.encode_frame(img)
            fv = None
        blended = [torch.stack([p, q]).mean(0) for p, q in zip(pooled, prev)]
        logits = model.fuse_target(c5, blended, feat_valid=fv)
        return pooled, _pred(logits, key, fv, (h, w))

    for name, batch, bucketed in (("stream", 1, False),
                                  ("stream4", 4, False),
                                  ("stream_bucketed", 1, True)):
        prev = [torch.zeros(batch, fc_dim, s, s, device=device)
                for s in model.pool_scales]
        out[name] = _stream_row(partial(frame, bucketed=bucketed), prev,
                                conf, counts["frames"], batch, device, gen)


def clipocr_rows(model, conf, counts, device, gen, out):
    """TCB-OCR streaming with one carried context (JAX bench.py:604-677):
    a frame is ``encode_frame``, the mean of its region context and the
    previous frame's, ``fuse_target``, upsample and argmax; exact, 4
    videos, bucketed (``ClipOCRBucketEngine``'s masked encode)."""
    h, w = conf["hw"]
    key = bucket_hw(h, w, WIDTH_BUCKET)

    @torch.inference_mode()
    def frame(img, ctx_prev, bucketed):
        if bucketed:
            feat, ctx = model.encode_frame(pad_to(img, key), valid_hw=(h, w))
            fv = feature_valid(*feat.shape[-2:], (h, w), key)
        else:
            feat, ctx = model.encode_frame(img)
            fv = None
        logits = model.fuse_target(feat, torch.stack([ctx, ctx_prev]).mean(0))
        return ctx, _pred(logits, key, fv, (h, w))

    for name, batch, bucketed in (("clipocr", 1, False),
                                  ("clipocr4", 4, False),
                                  ("clipocr_bucketed", 1, True)):
        ctx0 = torch.zeros(batch, 512, conf["num_class"], 1, device=device)
        out[name] = _stream_row(partial(frame, bucketed=bucketed), ctx0,
                                conf, counts["frames"], batch, device, gen)


def netwarp_rows(model, conf, counts, device, gen, out):
    """NetWarp streaming (JAX bench.py:850-915): a frame is its
    ``encode_frame`` and the pair's ``fuse_pair`` against the previous
    frame's cache (RAFT at 20 refinements, B1 and B4), upsample and argmax;
    exact, and bucketed as ``NetWarpBucketEngine`` runs it (the masked
    encode and RAFT at the /8 geometry inside the bucket: B6 too)."""
    h, w = conf["hw"]
    key = bucket_hw(h, w, WIDTH_BUCKET)

    @torch.inference_mode()
    def frame(img, prev, bucketed):
        kw = {}
        if bucketed:
            img, kw = pad_to(img, key), {"valid_hw": (h, w)}
        cache = model.encode_frame(img, **kw)
        c4 = cache[2] if model.ocr else None
        logits, _ = model.fuse_pair(img, prev[0], cache[0], prev[1][0],
                                    prev[1][1], c4, **kw)
        fv = feature_valid(*logits.shape[-2:], (h, w), key) if kw else None
        return (img, cache), _pred(logits, key, fv, (h, w))

    for name, bucketed in (("netwarp_stream", False),
                           ("netwarp_stream_bucketed", True)):
        with torch.inference_mode():
            img = torch.randn(1, 3, h, w, device=device, generator=gen)
            if bucketed:
                img = pad_to(img, key)
            state = (img, model.encode_frame(
                img, **({"valid_hw": (h, w)} if bucketed else {})))
        out[name] = _stream_row(partial(frame, bucketed=bucketed), state,
                                conf, counts["frames"], 1, device, gen,
                                contiguous=True)
        del state


def tdnet_rows(model, conf, counts, device, gen, out):
    """TDNet streaming (JAX bench.py:680-785): exact, 4 videos, bucketed;
    a frame is ``stream`` through path ``frame % 4`` with the carry, then
    upsample and argmax (``serving.TDNetStreamer``)."""
    h, w = conf["hw"]
    key = bucket_hw(h, w, WIDTH_BUCKET)

    @torch.inference_mode()
    def frame(img, carry, bucketed):
        state, i = carry
        if bucketed:
            logits, state = model.stream(pad_to(img, key), i % 4, state,
                                         valid_hw=(h, w))
            fv = feature_valid(*logits.shape[-2:], (h, w), key)
        else:
            logits, state = model.stream(img, i % 4, state)
            fv = None
        return (state, i + 1), _pred(logits, key, fv, (h, w),
                                     align_corners=True)

    for name, batch, bucketed in (("tdnet", 1, False), ("tdnet4", 4, False),
                                  ("tdnet_bucketed", 1, True)):
        state = init_td4_state(batch, td4_tokens(*(key if bucketed
                                                    else (h, w))), device)
        state["count"] = 3      # warm: every frame runs its attention
        out[name] = _stream_row(partial(frame, bucketed=bucketed), (state, 0),
                                conf, counts["frames"], batch, device, gen)


def hrnet_rows(model, conf, counts, device, gen, out):
    """Per-frame HRNetV2 + C1 over N frames as ``test.frame_pred`` runs a
    frame (contiguous NCHW, as the CLI gives it): exact and bucketed."""
    for name, bucket in (("hrnet", 0), ("hrnet_bucketed", WIDTH_BUCKET)):
        def frame(img, state, bucket=bucket):
            return state, frame_test.frame_pred(model, img, bucket)

        out[name] = _stream_row(frame, None, conf, counts["frames"], 1,
                                device, gen, contiguous=True)


def ocr_head_row(conf, counts, device, gen):
    """The JAX bench's OCR-head microbench in f32: a 3x3 conv 2048 -> 512,
    ``spatial_gather`` with 19-class logits and ``SpatialOCR(512, 256,
    512)``, batch 1, at ``ocr_hw`` squared; N calls on two inputs in
    turn."""
    s = conf["ocr_hw"]
    conv = Conv(2048, 512, 3, padding=1)
    ocr = SpatialOCR(512, 256, 512, dropout=0.0)
    for m in (conv, ocr):
        init_weights(m, torch.Generator().manual_seed(0))
        m.to(device).eval()
    feats = torch.randn(2, 1, 2048, s, s, device=device, generator=gen)
    probs = torch.randn(2, 1, 19, s, s, device=device, generator=gen)

    @torch.inference_mode()
    def step(i):
        x = conv(feats[i % 2])
        return _checksum(ocr(x, spatial_gather(x, probs[i % 2]))[0])

    return Row(device, step, counts["frames"]).measure()


def window_row(model, t1: int, conf, counts, device, gen, bucket: int = 0):
    """The window forward of ``test_clip._windows`` over M windows of t1
    frames, target last: the model, then upsample and argmax; with
    ``bucket`` padded to the bucket and masked, as the CLI's default."""
    h, w = conf["hw"]
    n = counts["windows"]
    windows = torch.randn(n, t1, 1, 3, h, w, device=device, generator=gen)

    def step(i):
        return _checksum(test_clip.window_pred(model, windows[i], bucket))

    row = Row(device, step, n).measure()
    row["per_second"] = n / row["seconds"]
    return row


def nonlocal3d_row(model, t1: int, conf, counts, device, gen):
    """Non-local 3D over M windows of t1 frames at exact shapes: a window's
    steady-state ``test_all`` work, the model and every frame's upsampled
    probabilities (``test_clip.window_probs``), their sum into one frame's
    accumulator and its argmax (``test_clip.frame_pred``)."""
    h, w = conf["hw"]
    n = counts["windows"]
    windows = torch.randn(n, t1, 1, 3, h, w, device=device, generator=gen)

    @torch.inference_mode()
    def step(i):
        probs = test_clip.window_probs(model, windows[i])
        acc = probs[0]
        for p in probs[1:]:
            acc += p
        return _checksum(test_clip.frame_pred(acc, t1))

    row = Row(device, step, n).measure()
    row["per_second"] = n / row["seconds"]
    return row


def train_rows(model, loss_fn, frames: int, steps: int, conf, device, gen,
               single: bool):
    """``train_step`` over ``steps`` distinct batches of ``frames`` frames x
    batch 2 x crop, back to back; with ``single`` also one step with its own
    readback (best of 3)."""
    c = conf["crop"]
    batches = [{"img": torch.randn(frames, 2, 3, c, c, device=device,
                                   generator=gen),
                "labels": torch.randint(0, conf["num_class"],
                                        (frames, 2, c, c), device=device,
                                        generator=gen)}
               for _ in range(steps)]
    model.train()
    set_dropout_generator(model, torch.Generator(device=device).manual_seed(0))
    optimizer, scheduler = create_clip_optimizer(model, lr=0.002,
                                                 max_iters=100)

    def step(i):
        return train_step(model, optimizer, scheduler, batches[i],
                          loss_fn)["loss"]

    rows = {"chained": Row(device, step, steps).measure()}
    if single:
        def readback(i):
            return torch.tensor(float(step(i)))

        rows["single"] = Row(device, readback, 1).measure()
    return rows


def tc_rows(conf, counts, device, gen):
    """``tc_cal.run_pair`` over P pairs of a random video, exact and
    bucketed."""
    h, w = conf["hw"]
    n = counts["pairs"]
    raft = RAFT(iters=RAFT_ITERS)
    init_weights(raft, torch.Generator().manual_seed(0))
    with torch.no_grad():
        raft.update_block.flow_head.conv2.weight.mul_(0.1)
        raft.update_block.flow_head.conv2.bias.mul_(0.1)
    raft.to(device).eval()
    frames = 255 * torch.rand(n + 1, 1, 3, h, w, device=device, generator=gen)
    preds = torch.randint(0, conf["num_class"], (n, 1, h, w), device=device,
                          generator=gen, dtype=torch.int32)
    rows = {}
    for name, bucket in (("tc", 0), ("tc_bucketed", WIDTH_BUCKET)):
        def step(i):
            return _checksum(tc_cal.run_pair(raft, frames[i], frames[i + 1],
                                             preds[i], bucket))

        rows[name] = Row(device, step, n).measure()
    return rows


#: JPEG frames the host rows decode (the JAX bench's 32)
HOST_FRAMES = 32


def host_decode_row(conf) -> dict:
    """Frames/s of PIL decode + ``native.normalize_u8`` over HOST_FRAMES
    JPEGs on one thread (host clock, best of 3)."""
    with tempfile.TemporaryDirectory() as root:
        make_synthetic_vspw(root, 1, HOST_FRAMES, conf["hw"],
                            conf["num_class"], seed=0, splits=("val",))
        vdir = os.path.join(root, "data", "video_000", "origin")
        paths = [os.path.join(vdir, n) for n in sorted(os.listdir(vdir))]

        def decode():
            for p in paths:
                native.normalize_u8(np.asarray(Image.open(p).convert("RGB")))

        decode()                               # warm the file cache
        times = []
        for _ in range(TRIALS):
            t0 = time.perf_counter()
            decode()
            times.append(time.perf_counter() - t0)
    return {"seconds": min(times),
            "spread_pct": 100.0 * (max(times) / min(times) - 1.0),
            "per_second": HOST_FRAMES / min(times),
            "path": f"PIL decode, normalize {native.status()}, one thread"}


def card(device):
    """(name, power limit in W, f32 peak FLOP/s) of the card, or Nones on
    the CPU; a card not in ``PEAK_F32_FLOPS`` is refused."""
    if device.type != "cuda":
        return "cpu", None, None
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[index]
    name, limit = (part.strip() for part in line.rsplit(",", 1))
    kind = torch.cuda.get_device_name(index)
    if kind not in PEAK_F32_FLOPS:
        raise RuntimeError(f"no f32 peak for {kind!r} in PEAK_F32_FLOPS")
    return name, float(limit.split()[0]), PEAK_F32_FLOPS[kind]


def build_parser():
    p = argparse.ArgumentParser(description="the port's benchmark")
    p.add_argument("--device", default="cuda")
    p.add_argument("--quick", action="store_true",
                   help="N=4 frames, M=2 windows, K=2 steps, P=2 pairs, at "
                        "full width and resolution")
    p.add_argument("--toy", action="store_true",
                   help="ResNet-18-dilated, 64x96 frames, 5 classes (the "
                        "CPU test)")
    return p


def run(args) -> dict:
    device = resolve_device(args.device)
    conf = CONFIGS["toy" if args.toy else "full"]
    counts = COUNTS["quick" if args.quick else "full"]
    name, power_limit, peak = card(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = default_cfg.clone()
    cfg.merge_from_file(os.path.join(PRESETS, conf["preset"]))
    k = conf["num_class"]
    gen = torch.Generator(device=device).manual_seed(0)
    rows = {}

    def free():
        _sync(device)
        if device.type == "cuda":
            torch.cuda.empty_cache()

    psp = _model(ClipPSP, cfg, k, device).eval()
    stream_rows(psp, cfg.MODEL.fc_dim, conf, counts, device, gen, rows)
    free()
    rows["baseline"] = window_row(psp, 4, conf, counts, device, gen)
    free()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    train = train_rows(psp, clip_psp_loss, 4, counts["train_steps"], conf,
                       device, gen, single=True)
    rows["train"], rows["train_single"] = train["chained"], train["single"]
    peak_mem = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                if device.type == "cuda" else None)
    del psp, train
    free()
    etc = _model(ETC, cfg, k, device, raft_iters=RAFT_ITERS)
    rows["etc_train"] = train_rows(etc, etc_loss, 2, counts["etc_train_steps"],
                                   conf, device, gen, single=False)["chained"]
    free()
    rows["etc_windows"] = window_row(etc.eval(), 2, conf, counts, device, gen)
    rows["etc_bucketed"] = window_row(etc, 2, conf, counts, device, gen,
                                      WIDTH_BUCKET)
    del etc
    free()
    warp = _model(ClipWarpNet, cfg, k, device, clip_num=4,
                  max_distances=(10,)).eval()
    rows["our_warp"] = window_row(warp, 4, conf, counts, device, gen)
    rows["our_warp_bucketed"] = window_row(warp, 4, conf, counts, device, gen,
                                           WIDTH_BUCKET)
    del warp
    free()
    for row, cls in (("propnet", PropNet), ("our_warp_merge", OurWarpMerge)):
        model = _model(cls, cfg, k, device).eval()
        rows[row] = window_row(model, 4, conf, counts, device, gen)
        del model
        free()
    rows.update(tc_rows(conf, counts, device, gen))
    free()
    host = host_decode_row(conf)
    # last, so that the rows before it run as before it was added: run
    # ahead of propnet's host-bound row, that row read 6.9% slower than
    # without it (H100, the two alternated); with this row last, 0.75%,
    # inside that row's spread
    warp = _model(ClipWarpNet, cfg, k, device, clip_num=4,
                  max_distances=(10,))
    rows["our_warp_train"] = train_rows(
        warp, partial(clip_warp_loss, allsup=True), 4,
        counts["train_steps"], conf, device, gen, single=False)["chained"]
    del warp
    free()
    # TCB-OCR and NetWarp after every earlier row, for the same reason
    ocr = _model(ClipOCRNet, cfg, k, device).eval()
    clipocr_rows(ocr, conf, counts, device, gen, rows)
    del ocr
    free()
    netwarp = _model(NetWarp, cfg, k, device, raft_iters=RAFT_ITERS)
    rows["netwarp_train"] = train_rows(
        netwarp, netwarp_loss, 2, counts["etc_train_steps"], conf, device,
        gen, single=False)["chained"]
    free()
    netwarp_rows(netwarp.eval(), conf, counts, device, gen, rows)
    del netwarp
    free()
    tdnet = TD4PSP(k, cropsize=conf["crop"])
    init_weights(tdnet, torch.Generator().manual_seed(0))
    tdnet_rows(tdnet.to(device).eval(), conf, counts, device, gen, rows)
    del tdnet
    free()
    nl3d = _model(NonLocal3D, cfg, k, device).eval()
    rows["nonlocal3d"] = nonlocal3d_row(nl3d, 3, conf, counts, device, gen)
    del nl3d
    free()
    hcfg = {}
    for row, preset in HRNET_PRESETS.items():
        hcfg[row] = default_cfg.clone()
        hcfg[row].merge_from_file(os.path.join(PRESETS, preset))
    hrnet = frame_test.build_segmentation(hcfg["hrnet"], k)
    init_weights(hrnet, torch.Generator().manual_seed(0))
    hrnet_rows(hrnet.to(device).eval(), conf, counts, device, gen, rows)
    del hrnet
    free()
    clip, _ = methods.build_method("hrnetv2_clip", hcfg["hrnetclip"],
                                   argparse.Namespace(num_class=k))
    init_weights(clip, torch.Generator().manual_seed(0))
    rows["hrnetclip"] = window_row(clip.to(device).eval(), 4, conf, counts,
                                   device, gen)
    del clip
    free()
    rows["ocr_head"] = ocr_head_row(conf, counts, device, gen)
    free()

    def mfu(row):
        if peak is None:
            return None
        value = row["flops"] / row["seconds"] / peak
        if not 0.0 < value <= 1.0:
            raise RuntimeError(f"mfu {value} outside (0, 1]: the operation "
                               "count is wrong")
        return value

    stream = rows["stream"]["per_second"]
    base = rows["baseline"]["per_second"]
    h, w = conf["hw"]
    arch = cfg.MODEL.arch_encoder.replace("resnet", "r").replace("dilated",
                                                                 "")
    return {
        "metric": f"tcb_psp_{arch}_{h}x{w}_streaming_inference",
        "value": stream,
        "unit": "frames/sec",
        "mfu": mfu(rows["stream"]),
        "stream4_frames_per_sec": rows["stream4"]["per_second"],
        "stream_bucketed_frames_per_sec":
            rows["stream_bucketed"]["per_second"],
        "stream_bucketed_overhead_pct":
            100.0 * (stream / rows["stream_bucketed"]["per_second"] - 1.0),
        "baseline_frames_per_sec": base,
        "vs_baseline": stream / base,
        "baseline_mfu": mfu(rows["baseline"]),
        "baseline_def": "reference window formulation (ClipPSP.forward over "
                        "4 frames a target frame), same model and card",
        "train_step_ms": 1e3 * rows["train"]["seconds"]
        / counts["train_steps"],
        "train_step_single_readback_ms": 1e3 * rows["train_single"]["seconds"],
        "train_mfu": mfu(rows["train"]),
        "train_peak_mem_gib": peak_mem,
        "train_shape": f"T+1=4 x B=2 x {conf['crop']}x{conf['crop']}, "
                       f"{counts['train_steps']} back-to-back steps / 1 "
                       "synchronise",
        "etc_train_step_ms": 1e3 * rows["etc_train"]["seconds"]
        / counts["etc_train_steps"],
        "etc_train_mfu": mfu(rows["etc_train"]),
        "our_warp_train_step_ms": 1e3 * rows["our_warp_train"]["seconds"]
        / counts["train_steps"],
        "our_warp_train_mfu": mfu(rows["our_warp_train"]),
        "etc_windows_per_sec": rows["etc_windows"]["per_second"],
        "etc_mfu": mfu(rows["etc_windows"]),
        "etc_bucketed_windows_per_sec": rows["etc_bucketed"]["per_second"],
        "our_warp_windows_per_sec": rows["our_warp"]["per_second"],
        "our_warp_mfu": mfu(rows["our_warp"]),
        "our_warp_bucketed_windows_per_sec":
            rows["our_warp_bucketed"]["per_second"],
        "propnet_windows_per_sec": rows["propnet"]["per_second"],
        "propnet_mfu": mfu(rows["propnet"]),
        "our_warp_merge_windows_per_sec":
            rows["our_warp_merge"]["per_second"],
        "our_warp_merge_mfu": mfu(rows["our_warp_merge"]),
        "tc_ms_per_pair": 1e3 * rows["tc"]["seconds"] / counts["pairs"],
        "tc_bucketed_ms_per_pair":
            1e3 * rows["tc_bucketed"]["seconds"] / counts["pairs"],
        "tc_mfu": mfu(rows["tc"]),
        "clipocr_frames_per_sec": rows["clipocr"]["per_second"],
        "clipocr_mfu": mfu(rows["clipocr"]),
        "clipocr_stream4_frames_per_sec": rows["clipocr4"]["per_second"],
        "clipocr_bucketed_frames_per_sec":
            rows["clipocr_bucketed"]["per_second"],
        "clipocr_bucketed_overhead_pct":
            100.0 * (rows["clipocr"]["per_second"]
                     / rows["clipocr_bucketed"]["per_second"] - 1.0),
        "netwarp_stream_frames_per_sec": rows["netwarp_stream"]["per_second"],
        "netwarp_stream_mfu": mfu(rows["netwarp_stream"]),
        "netwarp_stream_bucketed_frames_per_sec":
            rows["netwarp_stream_bucketed"]["per_second"],
        "netwarp_train_step_ms": 1e3 * rows["netwarp_train"]["seconds"]
        / counts["etc_train_steps"],
        "netwarp_train_mfu": mfu(rows["netwarp_train"]),
        "tdnet_frames_per_sec": rows["tdnet"]["per_second"],
        "tdnet_mfu": mfu(rows["tdnet"]),
        "tdnet_stream4_frames_per_sec": rows["tdnet4"]["per_second"],
        "tdnet_bucketed_frames_per_sec":
            rows["tdnet_bucketed"]["per_second"],
        "tdnet_bucketed_overhead_pct":
            100.0 * (rows["tdnet"]["per_second"]
                     / rows["tdnet_bucketed"]["per_second"] - 1.0),
        "nonlocal3d_windows_per_sec": rows["nonlocal3d"]["per_second"],
        "nonlocal3d_mfu": mfu(rows["nonlocal3d"]),
        "hrnet_frames_per_sec": rows["hrnet"]["per_second"],
        "hrnet_mfu": mfu(rows["hrnet"]),
        "hrnet_bucketed_frames_per_sec":
            rows["hrnet_bucketed"]["per_second"],
        "hrnet_bucketed_overhead_pct":
            100.0 * (rows["hrnet"]["per_second"]
                     / rows["hrnet_bucketed"]["per_second"] - 1.0),
        "hrnetclip_windows_per_sec": rows["hrnetclip"]["per_second"],
        "hrnetclip_mfu": mfu(rows["hrnetclip"]),
        "ocr_head_ms": 1e3 * rows["ocr_head"]["seconds"] / counts["frames"],
        "ocr_head_mfu": mfu(rows["ocr_head"]),
        "ocr_head_shape": f"conv3x3 2048->512 + spatial_gather (19 classes) "
                          f"+ SpatialOCR(512, 256, 512), 1x{conf['ocr_hw']}x"
                          f"{conf['ocr_hw']}, float32 (the JAX bench's row "
                          "runs bfloat16)",
        "host_decode_frames_per_sec": host["per_second"],
        "host_decode_path": host["path"],
        "host_cores_to_saturate_chip": math.ceil(stream
                                                 / host["per_second"]),
        "spreads_pct": {**{n: r["spread_pct"] for n, r in rows.items()},
                        "host_decode": host["spread_pct"]},
        "device": name,
        "power_limit_w": power_limit,
        "peak_tflops_f32": None if peak is None else peak / 1e12,
        "dtype": "float32",
        "not_ported": NOT_PORTED,
        "counts": counts,
        "flops": {n: r["flops"] for n, r in rows.items()},
        "launches": {n: r["launches"] for n, r in rows.items()},
    }


def main(argv=None) -> dict:
    out = run(build_parser().parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

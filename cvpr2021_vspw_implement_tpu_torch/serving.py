"""Streaming inference: encode each frame once, reuse what later windows
need (JAX counterpart: serving.py ``_WindowStreamer``, ``ClipPSPStreamer``,
``ClipOCRStreamer``, ``NetWarpStreamer``, their bucket engines,
``ExactShapeEngine``, ``video_shape_census``).

TCB-PSP's blend only consumes each frame's pooled PPM statistics (at most
6x6xC) and the target's C5 map, and TCB-OCR's each frame's region context
([K, 512]) and the target's OCR features, so each video frame is encoded
exactly once, its stats cached, and windows fused as their future context
arrives.  NetWarp caches each frame's C5 and decoder features (and C4 for
the OCR decoder) and runs only the pair's own work, flow, blends and the
target's decode, per frame.  Predictions equal the window forward.  TDNet
streams by design: one path a frame, with the video's K/V/Q carry.

An engine decides the shapes a frame runs at: a bucket engine pads it to
its width bucket and runs the masked model (ops/masked.py);
``ExactShapeEngine`` and no engine run it at its own shape.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image

from .models.segmentation import inference_pred, inference_pred_rt
from .models.td4_psp import init_td4_state, td4_tokens
from .ops.masked import bucket_hw, feature_valid, pad_to


class ExactShapeEngine:
    """Frames at their own shape (the ``exact`` leg of ``--eval_policy``).
    The JAX package caches one compiled kernel per shape here; eager
    PyTorch has nothing to compile, so the engine only records the shapes
    it ran (``encode_shapes``).  The frame goes to the model as a permuted
    HWC view, as the streamer without an engine gives it."""

    def __init__(self, model, device=None):
        self.model = model
        self.device = torch.device(device) if device is not None \
            else next(model.parameters()).device
        self._shapes: set[tuple[int, int]] = set()

    @property
    def encode_shapes(self):
        return sorted(self._shapes)

    def encode(self, frame: np.ndarray):
        """frame [H, W, 3] normalized → the model's per-frame cache."""
        self._shapes.add(tuple(frame.shape[:2]))
        img = torch.from_numpy(np.ascontiguousarray(frame)).to(
            self.device).permute(2, 0, 1)[None]
        return self.model.encode_frame(img)

    def fuse(self, c5, blended, true_hw) -> np.ndarray:
        """Fuse and argmax at the frame's size → [H, W] uint8."""
        logits = self.model.fuse_target(c5, blended)
        return inference_pred(logits, true_hw)[0].cpu().numpy()


class ClipPSPBucketEngine(ExactShapeEngine):
    """Width-bucketed ClipPSP eval, shared by all videos of a run: each
    frame is zero-padded to ``bucket_hw`` (width to a multiple of
    ``bucket``, height to the stride 32) as contiguous NCHW, and the masked
    ``encode_frame`` / ``fuse_target`` take its true size.  Predictions on
    the valid region equal the exact run's up to the order of f32 sums.
    ``encode_shapes`` holds one entry per bucket touched."""

    def __init__(self, model, bucket: int = 64):
        if bucket % 32:
            raise ValueError("bucket must cover the encoder stride (32)")
        super().__init__(model)
        self.bucket = bucket

    def pad_hw(self, h: int, w: int) -> tuple[int, int]:
        return bucket_hw(h, w, self.bucket)

    def encode(self, frame: np.ndarray):
        """frame [H, W, 3] normalized → (C5 on the bucket grid with a zero
        band, the stats of the true frame)."""
        h, w = frame.shape[:2]
        key = self.pad_hw(h, w)
        self._shapes.add(key)
        img = pad_to(torch.from_numpy(np.ascontiguousarray(frame)).to(
            self.device).permute(2, 0, 1)[None], key)
        return self.model.encode_frame(img, valid_hw=(h, w))

    def fuse(self, c5, blended, true_hw) -> np.ndarray:
        """Fuse and argmax at the true size ``true_hw`` → [H, W] uint8."""
        h, w = true_hw
        key = self.pad_hw(h, w)
        fv = feature_valid(c5.shape[2], c5.shape[3], (h, w), key)
        logits = self._fuse_target(c5, blended, fv)
        pred = inference_pred_rt(logits, key, fv, (h, w))
        return pred[0, :h, :w].cpu().numpy()

    def _fuse_target(self, c5, blended, fv):
        return self.model.fuse_target(c5, blended, feat_valid=fv)


class ClipOCRBucketEngine(ClipPSPBucketEngine):
    """Width-bucketed ClipOCR eval (JAX ``ClipOCRBucketEngine``): the
    masked encode (the trunk and both heads' 3x3 convs under the
    spatial-conv-input mask, the features re-zeroed, the gather over the
    valid region), then the fuse on the padded grid: the OCR attention and
    fuse past the gather are per pixel, so the band never reaches the
    valid region."""

    def _fuse_target(self, feat, context, fv):
        return self.model.fuse_target(feat, context)


def video_shape_census(dataroot, videos):
    """({(h, w): total frames}, {video: (h, w)}) from the first frame's
    header of each video (PIL reads the size without decoding): what
    ``--eval_policy auto`` decides by."""
    census, shapes = {}, {}
    for v in videos:
        d = os.path.join(dataroot, "data", v, "origin")
        frames = os.listdir(d)
        if not frames:
            continue
        with Image.open(os.path.join(d, sorted(frames)[0])) as im:
            w, h = im.size
        shapes[v] = (h, w)
        census[(h, w)] = census.get((h, w), 0) + len(frames)
    return census, shapes


class _WindowStreamer:
    """Lookahead loop: encode frames once, fuse a window when every
    member's cached stats are available."""

    def __init__(self, model, dilation2, num_frames: int, seg_size,
                 device="cuda", engine=None):
        self.model = model
        self.dilation2 = list(dilation2)
        self.n = num_frames
        self.seg_size = tuple(seg_size)
        self.engine = engine or ExactShapeEngine(model, device)

    def context_indices(self, i: int) -> list[int]:
        """Window offsets with the reference's end-of-video flip
        (TestDataset_longclip, dataset2.py:460-466); negative indices wrap
        like python list indexing in the reference."""
        out = []
        for dil in self.dilation2:
            j = i - dil if i + self.dilation2[-1] >= self.n else i + dil
            out.append(j % self.n)
        return out

    @torch.inference_mode()
    def run(self, frames_iter):
        """frames_iter yields [H, W, 3] normalized float32 frames in order;
        yields (frame_idx, pred [H, W] uint8) in order."""
        stats_cache: dict[int, object] = {}
        feat_buffer: dict[int, torch.Tensor] = {}
        next_to_fuse = 0
        for j, frame in enumerate(frames_iter):
            feat_buffer[j], stats_cache[j] = self.engine.encode(frame)
            while next_to_fuse < self.n:
                i = next_to_fuse
                ctx = self.context_indices(i)
                if any(k > j for k in [i] + ctx):
                    break
                yield i, self.engine.fuse(feat_buffer.pop(i),
                                          self._blend(stats_cache,
                                                      [i] + ctx),
                                          self.seg_size)
                next_to_fuse += 1


class ClipPSPStreamer(_WindowStreamer):
    """TCB-PSP: the cache holds each frame's per-scale pooled pyramids and,
    with ``psp_weight``, its weight logit; the blend keeps the reference's
    off-by-one pairing (features [target, ctx...], softmax weights in input
    order [ctx..., target], clip_psp.py:147-187), then takes the mean."""

    def _blend(self, cache, idxs):
        if not self.model.psp_weight:
            return [torch.stack([cache[k][s] for k in idxs]).mean(0)
                    for s in range(len(cache[idxs[0]]))]
        target, ctx = idxs[0], idxs[1:]
        wps = torch.stack([cache[k][1] for k in list(ctx) + [target]])
        w = torch.softmax(wps.float(), dim=0)              # [T, B]
        order = [target] + list(ctx)
        return [(torch.stack([cache[k][0][s] for k in order])
                 * w[:, :, None, None, None]).mean(0)
                for s in range(len(cache[target][0]))]


class ClipOCRStreamer(_WindowStreamer):
    """TCB-OCR without memory: the cache holds each frame's region context
    [B, 512, K, 1]; the blend is their mean."""

    def _blend(self, cache, idxs):
        return torch.stack([cache[k] for k in idxs]).mean(0)


class NetWarpEngine(ExactShapeEngine):
    """NetWarp / NetWarp-OCR frames at their own shape: a frame goes to the
    card once as contiguous NCHW (RAFT's kernels read it), is encoded, and
    is kept beside its features for the pairs that read it."""

    def _image(self, frame: np.ndarray) -> torch.Tensor:
        self._shapes.add(tuple(frame.shape[:2]))
        return torch.from_numpy(np.ascontiguousarray(frame)).to(
            self.device).permute(2, 0, 1)[None].contiguous()

    def encode(self, frame: np.ndarray):
        """frame [H, W, 3] normalized → (image, C5, features[, C4])."""
        img = self._image(frame)
        return (img, *self.model.encode_frame(img))

    def fuse(self, target, prev, true_hw) -> np.ndarray:
        """The pair (target, prev) of cache entries → the target's
        prediction [H, W] uint8."""
        logits, _ = self.model.fuse_pair(*self._pair(target, prev))
        return inference_pred(logits, true_hw)[0].cpu().numpy()

    @staticmethod
    def _pair(target, prev):
        """fuse_pair's arguments: images, C5 of both, prev's features, and
        the target's C4 for the OCR decoder."""
        return (target[0], prev[0], target[1], prev[1], prev[2],
                target[3] if len(target) > 3 else None)


class NetWarpBucketEngine(NetWarpEngine):
    """Width-bucketed NetWarp / NetWarp-OCR eval (JAX
    ``NetWarpBucketEngine``), shared by all videos of a run: the masked
    encode, and a fuse whose frozen RAFT runs at the reference's symmetric
    /8 geometry inside the bucket, with nearest flow resizes and warps at
    the true sizes (``NetWarp.fuse_pair``)."""

    def __init__(self, model, bucket: int = 64):
        if bucket % 32:
            raise ValueError("bucket must cover the encoder stride (32)")
        super().__init__(model)
        self.bucket = bucket

    def _image(self, frame):
        h, w = frame.shape[:2]
        key = bucket_hw(h, w, self.bucket)
        self._shapes.add(key)
        return pad_to(torch.from_numpy(np.ascontiguousarray(frame)).to(
            self.device).permute(2, 0, 1)[None], key)

    def encode(self, frame):
        img = self._image(frame)
        return (img, *self.model.encode_frame(img,
                                              valid_hw=frame.shape[:2]))

    def fuse(self, target, prev, true_hw):
        h, w = true_hw
        key = target[0].shape[-2:]
        logits, _ = self.model.fuse_pair(*self._pair(target, prev),
                                         valid_hw=(h, w))
        fv = feature_valid(*logits.shape[-2:], (h, w), key)
        pred = inference_pred_rt(logits, key, fv, (h, w))
        return pred[0, :h, :w].cpu().numpy()


class NetWarpStreamer:
    """NetWarp / NetWarp-OCR eval with each frame's features computed once
    (``clip_num`` 2, ``dilation_num`` 0, the reference's only NetWarp
    setting).  Frame i pairs with the frame before it, frame 0 with frame 1
    (TestDataset_clip, dataset2.py:276-300); a frame's cache entry is
    dropped once no later pair reads it.  Predictions equal the window
    forward's."""

    def __init__(self, model, num_frames: int, seg_size, device="cuda",
                 engine=None):
        self.n = num_frames
        self.seg_size = tuple(seg_size)
        self.engine = engine or NetWarpEngine(model, device)

    def context_index(self, i: int) -> int:
        """The previous frame; the first frame takes the next one (itself
        in a video of one frame, as the window dataset gives it)."""
        if i == 0:
            return 1 if self.n > 1 else 0
        return i - 1

    @torch.inference_mode()
    def run(self, frames):
        """frames: [H, W, 3] normalized float32 frames, indexable; yields
        (frame_idx, pred [H, W] uint8) in order."""
        cache: dict[int, tuple] = {}

        def get(idx):
            if idx not in cache:
                cache[idx] = self.engine.encode(frames[idx])
            return cache[idx]

        for i in range(self.n):
            j = self.context_index(i)
            yield i, self.engine.fuse(get(i), get(j), self.seg_size)
            for k in [k for k in cache if k < i]:
                del cache[k]


class TDNetStreamer:
    """TDNet eval of one video (JAX test_clip.py:469-563): frame i through
    path ``i % 4`` with the video's K/V/Q carry.  With ``bucket`` every
    frame is padded to the bucket of the video's first frame and the masked
    stream takes the true size; the carry then lives on the bucket's token
    grid, so one bucketed step serves every video of that bucket.  Without
    it, each frame runs at its own shape.  The logits are upsampled
    ``align_corners=True``, TDNet's convention.  ``shapes`` collects the
    frame shapes run (the buckets, when bucketed)."""

    def __init__(self, model, seg_size, device="cuda", bucket: int = 0,
                 shapes: set | None = None):
        if bucket % 32:
            raise ValueError("bucket must cover the encoder stride (32)")
        self.model = model
        self.seg_size = tuple(seg_size)
        self.device = torch.device(device)
        self.bucket = bucket
        self.shapes = set() if shapes is None else shapes

    @torch.inference_mode()
    def run(self, frames):
        """frames: [H, W, 3] normalized float32 frames in order; yields
        (frame_idx, pred [H, W] uint8)."""
        h, w = self.seg_size
        key = bucket_hw(h, w, self.bucket) if self.bucket else (h, w)
        self.shapes.add(key)
        state = init_td4_state(1, td4_tokens(*key), self.device)
        for i, frame in enumerate(frames):
            img = torch.from_numpy(np.ascontiguousarray(frame)).to(
                self.device).permute(2, 0, 1)[None]
            if not self.bucket:
                logits, state = self.model.stream(img, i % 4, state)
                yield i, inference_pred(logits, (h, w), align_corners=True)[
                    0].cpu().numpy()
                continue
            logits, state = self.model.stream(pad_to(img, key), i % 4, state,
                                              valid_hw=(h, w))
            fv = feature_valid(*logits.shape[-2:], (h, w), key)
            pred = inference_pred_rt(logits, key, fv, (h, w),
                                     align_corners=True)
            yield i, pred[0, :h, :w].cpu().numpy()

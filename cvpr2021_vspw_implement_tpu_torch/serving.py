"""Streaming TCB-PSP inference: encode each frame once, reuse its pooled
stats (JAX counterpart: serving.py ``_WindowStreamer``, ``ClipPSPStreamer``;
exact shapes only).

The blend only consumes each frame's pooled PPM statistics (at most 6x6xC)
and the target's C5 map, so each video frame is encoded exactly once, its
stats cached, and windows fused as their future context arrives.
Predictions equal the window forward (``ClipPSP.forward``).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.segmentation import inference_pred


class _WindowStreamer:
    """Lookahead loop: encode frames once, fuse a window when every
    member's cached stats are available."""

    def __init__(self, model, dilation2, num_frames: int, seg_size,
                 device="cuda"):
        self.model = model
        self.dilation2 = list(dilation2)
        self.n = num_frames
        self.seg_size = tuple(seg_size)
        self.device = torch.device(device)

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
            img = torch.from_numpy(np.ascontiguousarray(frame)).to(
                self.device).permute(2, 0, 1)[None]
            feat_buffer[j], stats_cache[j] = self._encode(img)
            while next_to_fuse < self.n:
                i = next_to_fuse
                ctx = self.context_indices(i)
                if any(k > j for k in [i] + ctx):
                    break
                pred = self._fuse(feat_buffer.pop(i),
                                  self._blend(stats_cache, [i] + ctx))
                yield i, pred[0].cpu().numpy()
                next_to_fuse += 1


class ClipPSPStreamer(_WindowStreamer):
    """TCB-PSP: the cache holds each frame's per-scale pooled pyramids and,
    with ``psp_weight``, its weight logit; the blend keeps the reference's
    off-by-one pairing (features [target, ctx...], softmax weights in input
    order [ctx..., target], clip_psp.py:147-187), then takes the mean."""

    def _encode(self, img):
        return self.model.encode_frame(img)

    def _fuse(self, c5, blended):
        logits = self.model.fuse_target(c5, blended)
        return inference_pred(logits, self.seg_size)

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

"""The flow of one TC pair (``tc_cal.pair_flow``) and the check of bucketed
TC that ``chip_smoke.py`` runs on the card, on the CPU at a small size.

RAFT with seeded weights and 3 refinements (the flow head scaled by 0.1, a
trained-like step, as chip_smoke.py does) over 64x100 frames, whose width
bucket is 128 and whose /8 pad is a roll of two columns inside it:

* the bucketed and exact flows of a pair agree on the pair's size within
  1e-3 px (the CPU bar of tests/test_torch_bucketed_eval.py's masked RAFT);
* ``run_pair`` returns what it returned before the flow was split out of it
  (the composition it had, replayed here);
* the planted fault of the check, the masked RAFT's ``mask_valid`` replaced
  by the identity, puts the bucketed flow past the check's limit, and the
  check as a whole (which decides after the first refinement) passes the
  code as shipped and fails the fault.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from cvpr2021_vspw_implement_tpu_torch import tc_cal
from cvpr2021_vspw_implement_tpu_torch.models.layers import init_weights
from cvpr2021_vspw_implement_tpu_torch.models.raft import (
    RAFT, pad_to_multiple_of_8, unpad)
from cvpr2021_vspw_implement_tpu_torch.models.raft import raft as raft_mod
from cvpr2021_vspw_implement_tpu_torch.ops.masked import (bucket_hw,
                                                          mask_valid, pad_to)
from cvpr2021_vspw_implement_tpu_torch.ops.warp import flowwarp
from torch_port_util import to_nchw

H, W, K = 64, 100, 5


@pytest.fixture(scope="module")
def raft():
    model = RAFT(iters=3)
    init_weights(model, torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(0.1)
        model.update_block.flow_head.conv2.bias.mul_(0.1)
    return model.eval()


@pytest.fixture(scope="module")
def video():
    """Three frames, each the last shifted by (1, 2) px plus noise, in
    [0, 255] as [1, 3, H, W]; and the next predictions [1, H, W] int32."""
    rng = np.random.default_rng(0)
    frames = [rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32)]
    for _ in range(2):
        frames.append(np.roll(frames[-1], (1, 2), axis=(1, 2))
                      + rng.normal(0, 4, frames[-1].shape).astype(np.float32))
    images = [to_nchw(f) for f in frames]
    preds = [torch.from_numpy(rng.integers(0, K, (1, H, W), dtype=np.int32))
             for _ in frames[1:]]
    return list(zip(images, images[1:])), preds


def test_pair_flow_bucketed_matches_exact(raft, video):
    pairs, _ = video
    for a, b in pairs:
        exact = tc_cal.pair_flow(raft, a, b, 0)
        bucketed = tc_cal.pair_flow(raft, a, b, 64)
        assert exact.shape == bucketed.shape == (1, 2, H, W)
        np.testing.assert_allclose(bucketed.numpy(), exact.numpy(),
                                   atol=1e-3, rtol=0)


@torch.inference_mode()
def _run_pair_before_split(model, img1, img2, next_pred, width_bucket):
    """``tc_cal.run_pair`` as it was before ``pair_flow``: exact shapes, or
    the flow warped on the bucket grid with its band re-zeroed, then
    cropped."""
    if not width_bucket:
        p1, pads = pad_to_multiple_of_8(img1)
        p2, _ = pad_to_multiple_of_8(img2)
        flow = unpad(model(p1, p2)[1], pads)
        warped = flowwarp(next_pred[:, None].float(), flow, mode="nearest")
        return warped[:, 0].to(torch.int32)
    h, w = img1.shape[-2:]
    key = bucket_hw(h, w, width_bucket)
    pad_h = (((h // 8) + 1) * 8 - h) % 8
    pad_w = (((w // 8) + 1) * 8 - w) % 8
    top, left = pad_h // 2, pad_w // 2
    r1 = torch.roll(pad_to(img1, key), (top, left), (2, 3))
    r2 = torch.roll(pad_to(img2, key), (top, left), (2, 3))
    _, flow = model(r1, r2, valid_hw=(h + pad_h, w + pad_w))
    flow = mask_valid(torch.roll(flow, (-top, -left), (2, 3)), (h, w))
    warped = flowwarp(pad_to(next_pred, key)[:, None].float(), flow,
                      mode="nearest", valid_hw=(h, w))
    return warped[:, 0].to(torch.int32)[:, :h, :w]


@pytest.mark.parametrize("width_bucket", [0, 64])
def test_run_pair_unchanged_by_the_split(raft, video, width_bucket):
    pairs, preds = video
    for (a, b), p in zip(pairs, preds):
        got = tc_cal.run_pair(raft, a, b, p, width_bucket)
        want = _run_pair_before_split(raft, a, b, p, width_bucket)
        assert got.shape == (1, H, W) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_planted_fault_passes_the_limit(raft, video, monkeypatch):
    pairs, preds = video
    exact = [tc_cal.pair_flow(raft, a, b, 0) for a, b in pairs]
    sound = [tc_cal.pair_flow(raft, a, b, 64) for a, b in pairs]
    monkeypatch.setattr(raft_mod, "mask_valid", lambda x, valid_hw: x)
    planted = [tc_cal.pair_flow(raft, a, b, 64) for a, b in pairs]
    ok = chip_smoke.flow_gap(torch, exact, sound, preds)
    bad = chip_smoke.flow_gap(torch, exact, planted, preds)
    assert ok["max_abs_px"] <= 1e-3
    assert bad["max_abs_px"] > chip_smoke.TC_FLOW_LIMIT_PX


def test_tc_check_passes_sound_and_fails_planted(raft, video):
    pairs, preds = video
    swapped = raft_mod.mask_valid, raft_mod.lookup_corr_pyramid
    readings = chip_smoke.tc_flow_check(torch, raft, pairs, preds)
    assert (raft_mod.mask_valid, raft_mod.lookup_corr_pyramid) == swapped
    assert raft.iters == 3
    assert sorted(readings) == sorted(chip_smoke.TC_CHECK_REFINEMENTS)
    runs = readings[1]                   # the check decides on the first
    assert runs["sound"]["max_abs_px"] <= chip_smoke.TC_FLOW_LIMIT_PX
    assert runs["control"]["max_abs_px"] == 0.0        # plain on both sides
    assert runs["planted"]["max_abs_px"] > chip_smoke.TC_FLOW_LIMIT_PX

"""Optical flow as colour (JAX counterpart: models/raft/flow_viz.py;
reference RAFT_core/utils/flow_viz.py): the Middlebury colour wheel of
Baker et al. (ICCV 2007), hue the direction and saturation the magnitude
over the largest, in numpy."""

from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    """The 55-entry RGB colour wheel."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    ramps = [
        (RY, 0, 1, False), (YG, 0, 1, True), (GC, 1, 2, False),
        (CB, 1, 2, True), (BM, 2, 0, False), (MR, 2, 0, True),
    ]
    for n, c_full, c_ramp, descending in ramps:
        wheel[col:col + n, c_full] = 255
        ramp = np.floor(255 * np.arange(n) / n)
        if descending:
            wheel[col:col + n, c_full] = 255 - ramp
            wheel[col:col + n, c_ramp] = 255
        else:
            wheel[col:col + n, c_ramp] = ramp
        col += n
    return wheel


def flow_to_image(flow: np.ndarray, clip_flow: float | None = None,
                  rad_max: float | None = None) -> np.ndarray:
    """flow [H, W, 2] → uint8 RGB [H, W, 3]."""
    u, v = flow[..., 0].astype(np.float64), flow[..., 1].astype(np.float64)
    if clip_flow is not None:
        u = np.clip(u, -clip_flow, clip_flow)
        v = np.clip(v, -clip_flow, clip_flow)
    rad = np.sqrt(u ** 2 + v ** 2)
    if rad_max is None:
        rad_max = max(rad.max(), 1e-5)
    u, v = u / rad_max, v / rad_max
    rad = np.sqrt(u ** 2 + v ** 2)

    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros((*u.shape, 3), np.uint8)
    small = rad <= 1
    for c in range(3):
        col0 = wheel[k0, c] / 255.0
        col1 = wheel[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col[small] = 1 - rad[small] * (1 - col[small])
        col[~small] = col[~small] * 0.75
        img[..., c] = np.floor(255 * col)
    return img

"""RAFT correlation-pyramid window lookup: the CUDA kernel and its plain
version (JAX counterparts: ops/pallas/corr.py::lookup_corr_pyramid_fused and
models/raft/corr.py::lookup_corr_pyramid).

For each query pixel, a bilinear sample of a (2r+1)^2 window around
coords / 2^l on every pyramid level, zero outside the level, channel
``l*(2r+1)^2 + tx*(2r+1) + ty`` (x the outer tap, y the inner one).
"""

from __future__ import annotations

import torch

from .. import kernels


def _lookup_level_plain(corr: torch.Tensor, cx: torch.Tensor,
                        cy: torch.Tensor, r: int) -> torch.Tensor:
    """corr [B, P, Hl, Wl]; cx, cy [B, P] in level pixels → [B, P, k*k]."""
    b, p, hl, wl = corr.shape
    k = 2 * r + 1
    if hl * wl == 0:
        return corr.new_zeros(b, p, k * k)
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=corr.device)

    def taps(c, size):
        c0 = torch.floor(c)
        lam = c - c0
        i0 = c0.to(torch.int64)
        i1 = i0 + 1
        v0 = (i0 >= 0) & (i0 <= size - 1)
        v1 = (i1 >= 0) & (i1 <= size - 1)
        return (i0.clamp(0, size - 1), (1 - lam) * v0,
                i1.clamp(0, size - 1), lam * v1)

    x0, wx0, x1, wx1 = taps(cx[..., None] + d, wl)     # [B, P, k]
    y0, wy0, y1, wy1 = taps(cy[..., None] + d, hl)
    flat = corr.reshape(b, p, hl * wl)

    def gather(iy, ix):
        idx = iy[..., None, :] * wl + ix[..., :, None]  # [B, P, x, y]
        return torch.gather(flat, 2, idx.reshape(b, p, -1)).reshape(
            b, p, k, k)

    out = (gather(y0, x0) * (wy0[..., None, :] * wx0[..., :, None])
           + gather(y0, x1) * (wy0[..., None, :] * wx1[..., :, None])
           + gather(y1, x0) * (wy1[..., None, :] * wx0[..., :, None])
           + gather(y1, x1) * (wy1[..., None, :] * wx1[..., :, None]))
    return out.reshape(b, p, k * k)


def lookup_corr_pyramid_plain(pyramid, coords: torch.Tensor,
                              radius: int = 4) -> torch.Tensor:
    """Gather formulation: pyramid is a list of [B, P, Hl, Wl]; coords
    [B, 2, H1, W1] (x, y) in level-0 pixels → [B, L*(2r+1)^2, H1, W1]."""
    b, _, h1, w1 = coords.shape
    c = coords.reshape(b, 2, h1 * w1).float()
    outs = [_lookup_level_plain(corr.float(), c[:, 0] / 2.0 ** i,
                                c[:, 1] / 2.0 ** i, radius)
            for i, corr in enumerate(pyramid)]
    out = torch.cat(outs, dim=-1)                       # [B, P, C]
    return out.permute(0, 2, 1).reshape(b, -1, h1, w1)


def lookup_corr_pyramid(pyramid, coords: torch.Tensor,
                        radius: int = 4) -> torch.Tensor:
    """Window lookup of every pyramid level; the layout of
    :func:`lookup_corr_pyramid_plain`.  A CPU tensor takes the plain
    version; a CUDA tensor launches ``kernels/csrc/corr_lookup.cu``."""
    if coords.device.type == "cpu":
        return lookup_corr_pyramid_plain(pyramid, coords, radius)
    if coords.device.type != "cuda":
        raise RuntimeError(f"no corr lookup for device {coords.device}")
    b, two, h1, w1 = coords.shape
    p = h1 * w1
    if two != 2 or radius != 4 or not 1 <= len(pyramid) <= 4:
        raise ValueError("the corr-lookup kernel takes coords [B, 2, H, W], "
                         "radius 4 and 1 to 4 levels")
    for lev in pyramid:
        if (lev.dtype != torch.float32 or not lev.is_contiguous()
                or lev.device != coords.device or lev.shape[:2] != (b, p)):
            raise ValueError("pyramid levels must be contiguous float32 "
                             f"[{b}, {p}, Hl, Wl] on {coords.device}")
    if coords.dtype != torch.float32 or not coords.is_contiguous():
        raise ValueError("coords must be contiguous float32")
    n = len(pyramid)
    out = torch.empty(b, n * 81, h1, w1, device=coords.device)
    levels = list(pyramid) + [pyramid[0]] * (4 - n)
    hw = [d for lev in levels for d in (lev.shape[2], lev.shape[3])]
    lib = kernels.load("corr_lookup")
    rc = lib.corr_lookup_f32(*[lev.data_ptr() for lev in levels], *hw, n,
                             coords.data_ptr(), out.data_ptr(), b, p,
                             torch.cuda.current_stream(coords.device)
                             .cuda_stream)
    kernels.check(rc, "corr_lookup_f32")
    lookup_corr_pyramid.launches += 1
    return out


lookup_corr_pyramid.launches = 0

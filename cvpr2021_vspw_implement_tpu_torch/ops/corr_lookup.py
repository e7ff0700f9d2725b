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


def lookup_corr_pyramid_flops(b: int, h: int, w: int, levels: int,
                              radius: int = 4) -> int:
    """f32 operations of one lookup of ``levels`` levels for [B, 2, H, W]
    coords, for each query and level: the coordinate scaled to the level
    (2), each of the 2r+1 tap rows and columns (its coordinate, fraction,
    the fraction's complement and the two weights masked to the level: 5),
    and the bilinear blend of each window position (4 tap weights, 4
    products and 3 sums: 11)."""
    k = 2 * radius + 1
    return b * h * w * levels * (2 + 2 * 5 * k + 11 * k * k)


def lookup_corr_pyramid(pyramid, coords: torch.Tensor,
                        radius: int = 4) -> torch.Tensor:
    """Window lookup of every pyramid level; the layout of
    :func:`lookup_corr_pyramid_plain`.  A CPU tensor takes the plain
    version; a CUDA tensor launches ``kernels/csrc/corr_lookup.cu`` (no
    backward: it refuses tensors that require grad).  On every device the
    arguments must be what the kernel takes: coords contiguous float32
    [B, 2, H, W], radius 4 and 1 to 4 contiguous float32 levels
    [B, H*W, Hl, Wl] on the coords' device."""
    b, two, h1, w1 = coords.shape
    p = h1 * w1
    n = len(pyramid)
    if two != 2 or radius != 4 or not 1 <= n <= 4:
        raise ValueError("the corr-lookup kernel takes coords [B, 2, H, W], "
                         "radius 4 and 1 to 4 levels")
    if coords.dtype != torch.float32 or not coords.is_contiguous():
        raise ValueError("coords must be contiguous float32")
    # one pass over the levels: checks, and the kernel's shape arguments
    dev = coords.device
    dims, grad = [], coords.requires_grad
    for lev in pyramid:
        lb, lp, lh, lw = lev.shape if lev.dim() == 4 else (0, 0, 0, 0)
        if (lb != b or lp != p or lev.dtype != torch.float32
                or not lev.is_contiguous() or lev.device != dev):
            raise ValueError("pyramid levels must be contiguous float32 "
                             f"[{b}, {p}, Hl, Wl] on {dev}")
        dims += (lh, lw)
        grad = grad or lev.requires_grad
    if not coords.is_cuda:
        if dev.type != "cpu":
            raise RuntimeError(f"no corr lookup for device {dev}")
        return lookup_corr_pyramid_plain(pyramid, coords, radius)
    if grad:
        raise ValueError("the corr-lookup kernel has no backward: it takes "
                         "no tensor that requires grad")
    out = torch.empty(b, n * 81, h1, w1, device=dev)
    ptrs = [lev.data_ptr() for lev in pyramid]
    # unused level slots repeat level 0
    rc = kernels.entry("corr_lookup_f32")(
        *ptrs, *[ptrs[0]] * (4 - n), *dims, *dims[:2] * (4 - n), n,
        coords.data_ptr(), out.data_ptr(), b, p,
        kernels.stream(coords.get_device()))
    kernels.check(rc, "corr_lookup_f32")
    lookup_corr_pyramid.launches += 1
    lookup_corr_pyramid.flops += lookup_corr_pyramid_flops(b, h1, w1, n,
                                                           radius)
    return out


#: the kernel's launches, and their f32 operations
#: (:func:`lookup_corr_pyramid_flops`)
lookup_corr_pyramid.launches = 0
lookup_corr_pyramid.flops = 0

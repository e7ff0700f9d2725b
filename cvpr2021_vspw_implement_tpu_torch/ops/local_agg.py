"""Local cost-volume window aggregation: the CUDA kernels and their plain
versions (JAX counterparts: ops/pallas/local_agg.py::local_sigmoid_aggregate,
local_softmax_aggregate, local_nearest_aggregate, and the XLA composition
of models/warp_our.py::warp_one_scale over ops/local_pairwise.py).

Each function maps (x [B, Cd, H, W] query embedding, y_dist [B, Cd, H, W]
context embedding for the distances, y_val [B, Cv, H, W] context features,
radius r) to [B, Cv, H, W], with dist(p, q) over the (2r+1)^2 window as in
ops/local_pairwise.py (|y|^2 = 1e20 and y = 0 outside the image):

* sigmoid: sum_q 2 (1 - sigmoid(dist)) y_val(q) / k^2;
* softmax: weights softmax_q(1 / (dist * temp + 1e-5)), out-of-image
  positions kept in the denominator, sum_q w y_val(q) / k^2 (the
  reference's avgpool quirk);
* nearest: y_val at the window's argMAX of dist (the reference's quirk; an
  out-of-image position wins and gives 0), first occurrence in (dy, dx)
  order.

``valid_hw`` (every function): the true (rows, cols) of the maps inside a
width-bucketed buffer [.., H, W].  Positions at or beyond it are out of
image, as beyond the edge of an unpadded map (ops/local_pairwise.py), and
the output is zero there; on the valid region the result is the unpadded
run's.  The JAX package takes its XLA formulation when masked; the kernel
takes the valid size at run time.

A CPU tensor takes the plain version; a CUDA tensor launches
``kernels/csrc/local_agg.cu`` (the distances' dot products and the weighted
sum on the tensor cores at f32 accuracy: 3xTF32).

Gradients.  When an input requires grad (training), each function runs
through a ``torch.autograd.Function`` whose backward is explicit: on the
CPU the plain backward (``local_*_aggregate_backward_plain``, the formulas
of ``kernels/csrc/local_agg_bwd.cu`` in plain PyTorch, not autograd of the
plain forward), on the card the kernels of ``local_agg_bwd.cu``, which have
no Pallas counterpart (the JAX package trains through its XLA formulation).
Nearest's forward then also returns the index of each position's pick
(the same one the backward gathers through).  Training is at exact shapes:
``valid_hw`` with an input that requires grad raises, as the JAX package's
masked formulation is eval only; bucketed eval runs under
``torch.inference_mode()``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from .local_pairwise import (local_pairwise_dist, local_weighted_aggregate,
                             local_window_gather, valid_region)

#: limits of the kernels' shared-memory staging and register tiles
#: (local_agg.cu, local_agg_bwd.cu)
MAX_RADIUS = 15
MAX_DIST_CHANNELS = 256


def _zero_band(t: torch.Tensor, valid_hw) -> torch.Tensor:
    """``t`` with zeros beyond ``valid_hw`` (a new tensor), or ``t``."""
    if valid_hw is None:
        return t
    return torch.where(valid_region(t, valid_hw), t, 0.0)


def local_sigmoid_aggregate_plain(x, y_dist, y_val, r: int, valid_hw=None):
    k = 2 * r + 1
    dist = local_pairwise_dist(x, y_dist, r, valid_hw)
    wts = 1.0 - (torch.sigmoid(dist) - 0.5) * 2.0
    out = local_weighted_aggregate(_zero_band(y_val, valid_hw), wts, r)
    return _zero_band(out / (k * k), valid_hw)


def local_softmax_aggregate_plain(x, y_dist, y_val, r: int,
                                  temp: float = 3.0, valid_hw=None):
    k = 2 * r + 1
    flat = local_pairwise_dist(x, y_dist, r, valid_hw).flatten(1, 2)
    wts = torch.softmax(1.0 / (flat * temp + 1e-5), dim=1)
    out = local_weighted_aggregate(_zero_band(y_val, valid_hw),
                                   wts.unflatten(1, (k, k)), r)
    return _zero_band(out / (k * k), valid_hw)


def local_nearest_index_plain(x, y_dist, r: int, valid_hw=None):
    """[B, H, W] int64: each position's window offset dy * k + dx of the
    first maximum distance."""
    return torch.argmax(local_pairwise_dist(x, y_dist, r, valid_hw)
                        .flatten(1, 2), dim=1)


def local_nearest_aggregate_plain(x, y_dist, y_val, r: int, valid_hw=None,
                                  idx=None):
    """``idx``: the offsets to gather at (default: the plain argmax)."""
    if idx is None:
        idx = local_nearest_index_plain(x, y_dist, r, valid_hw)
    windows = local_window_gather(_zero_band(y_val, valid_hw),
                                  r).flatten(2, 3)           # [B, C, k*k, H, W]
    idx = idx[:, None, None].expand(-1, windows.shape[1], 1, -1, -1)
    return _zero_band(torch.gather(windows, 2, idx)[:, :, 0], valid_hw)


def local_aggregate_flops(mode: str, b: int, h: int, w: int, cd: int,
                          cv: int, r: int) -> int:
    """f32 operations of one aggregation: the window's dot products over
    Cd channels and, but for ``nearest``, the weighted sum over Cv
    channels, 2 per multiply-add."""
    channels = cd if mode == "nearest" else cd + cv
    return 2 * b * h * w * (2 * r + 1) ** 2 * channels


def _valid_size(fn, x, valid_hw) -> tuple[int, int]:
    """(Hv, Wv) of a call: ``valid_hw``, or the whole grid; raises unless
    1 <= Hv <= H and 1 <= Wv <= W."""
    h, w = x.shape[-2:]
    if valid_hw is None:
        return h, w
    hv, wv = (int(v) for v in valid_hw)
    if not (1 <= hv <= h and 1 <= wv <= w):
        raise ValueError(f"{fn.__name__}: valid size {hv}x{wv} outside the "
                         f"{h}x{w} grid")
    return hv, wv


def _launch(fn, mode: str, x, y_dist, y_val, r: int, hv: int, wv: int,
            *extra, idx=None):
    if x.device.type != "cuda":
        raise RuntimeError(f"no {fn.__name__} for device {x.device}")
    b, cd, h, w = x.shape
    cv = y_val.shape[1]
    if (y_dist.shape != x.shape or y_val.dim() != 4
            or y_val.shape[0] != b or y_val.shape[2:] != (h, w)):
        raise ValueError(f"{fn.__name__} takes x and y_dist [B, Cd, H, W] "
                         "and y_val [B, Cv, H, W]")
    if not 0 <= r <= MAX_RADIUS or not 1 <= cd <= MAX_DIST_CHANNELS:
        raise ValueError(f"{fn.__name__}: the kernel takes 0 <= r <= "
                         f"{MAX_RADIUS} and 1 <= Cd <= {MAX_DIST_CHANNELS}")
    kernels.check_inputs(fn.__name__, (x, y_dist, y_val))
    # the kernel writes every element, zeros beyond the valid size
    out = torch.empty(b, cv, h, w, device=x.device)
    entry = f"local_{mode}_agg_f32"
    # nearest alone takes the index buffer (null in eval)
    index = (None if idx is None else idx.data_ptr(),) if mode == "nearest" \
        else ()
    kernels.check(kernels.entry(entry)(
        x.data_ptr(), y_dist.data_ptr(), y_val.data_ptr(), out.data_ptr(),
        *index, b, cd, cv, h, w, hv, wv, r, *extra,
        kernels.stream(x.get_device())), entry)
    fn.launches += 1
    fn.flops += local_aggregate_flops(mode, b, h, w, cd, cv, r)
    return out


def _smooth_backward_plain(x, y_dist, y_val, g, r: int, weights_grads):
    """(dx, dy_dist, dy_val) of a smooth mode: the window's distances and
    A(p, q) = <g_p, y_val(q)> / k^2, ``weights_grads(dist, A)`` → (w, G)
    [B, k*k, H, W], then the sums of local_agg_bwd.cu:

        dx_p      = 2 x_p sum_q G - 2 sum_q G y_dist(q)
        dy_dist_q = 2 y_q sum_p G - 2 sum_p G x_p
        dy_val_q  = sum_p w g_p / k^2

    Each (dy, dx) offset is one shifted product; the key-side sums go
    into maps padded by r, whose border (keys outside the image) is
    dropped.  float32, or float64 for float64 inputs."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    b, cd, h, w = x.shape
    cv = y_val.shape[1]
    k = 2 * r + 1
    offsets = [(dy, dx) for dy in range(k) for dx in range(k)]
    xf, ydf, gf = x.to(ct), y_dist.to(ct), g.to(ct)
    dist = local_pairwise_dist(xf, ydf, r).flatten(1, 2)    # [B, k*k, H, W]
    vp = F.pad(y_val.to(ct), (r, r, r, r))
    a = torch.stack([(gf * vp[:, :, dy:dy + h, dx:dx + w]).sum(1)
                     for dy, dx in offsets], 1) / (k * k)
    wts, grads = weights_grads(dist, a)
    yp = F.pad(ydf, (r, r, r, r))
    gy = torch.zeros_like(xf)
    s_pad = xf.new_zeros(b, h + 2 * r, w + 2 * r)
    gx_pad = xf.new_zeros(b, cd, h + 2 * r, w + 2 * r)
    wg_pad = xf.new_zeros(b, cv, h + 2 * r, w + 2 * r)
    for n, (dy, dx) in enumerate(offsets):
        gn, wn = grads[:, n], wts[:, n]
        gy += gn[:, None] * yp[:, :, dy:dy + h, dx:dx + w]
        s_pad[:, dy:dy + h, dx:dx + w] += gn
        gx_pad[:, :, dy:dy + h, dx:dx + w] += gn[:, None] * xf
        wg_pad[:, :, dy:dy + h, dx:dx + w] += wn[:, None] * gf
    inner = (slice(r, r + h), slice(r, r + w))
    d_x = 2.0 * xf * grads.sum(1)[:, None] - 2.0 * gy
    d_yd = (2.0 * ydf * s_pad[:, None, inner[0], inner[1]]
            - 2.0 * gx_pad[..., inner[0], inner[1]])
    d_yv = wg_pad[..., inner[0], inner[1]] / (k * k)
    return d_x, d_yd, d_yv


def local_sigmoid_aggregate_backward_plain(x, y_dist, y_val, g, r: int):
    """Gradients of :func:`local_sigmoid_aggregate_plain` for the upstream
    gradient ``g`` [B, Cv, H, W] → (dx, dy_dist, dy_val):
    w = 2 (1 - sigmoid(d)), G = A (-2 sigmoid(d) (1 - sigmoid(d)))."""
    def weights_grads(dist, a):
        sg = torch.sigmoid(dist)
        return 1.0 - (sg - 0.5) * 2.0, a * (-2.0 * sg * (1.0 - sg))
    return _smooth_backward_plain(x, y_dist, y_val, g, r, weights_grads)


def local_softmax_aggregate_backward_plain(x, y_dist, y_val, g, r: int,
                                           temp: float = 3.0):
    """Gradients of :func:`local_softmax_aggregate_plain`: s = 1 / (d temp
    + 1e-5), w = softmax_q(s) (out-of-image positions in the denominator),
    G = -temp s^2 w (A - sum_q w A)."""
    def weights_grads(dist, a):
        sc = 1.0 / (dist * temp + 1e-5)
        wts = torch.softmax(sc, dim=1)
        wa = (wts * a).sum(1, keepdim=True)
        return wts, -temp * sc.square() * wts * (a - wa)
    return _smooth_backward_plain(x, y_dist, y_val, g, r, weights_grads)


def local_nearest_aggregate_backward_plain(idx, g, r: int):
    """dy_val of :func:`local_nearest_aggregate_plain` gathered at ``idx``
    [B, H, W] (the forward's offsets): each position's g added to the key
    it picked, offsets in ascending order as the kernel sums them; a pick
    outside the image takes nothing.  x and y_dist get no gradient (the
    argmax is a step function), as ``jax.grad`` gives through
    ``take_along_axis``."""
    b, cv, h, w = g.shape
    k = 2 * r + 1
    gf = g.float()
    out = gf.new_zeros(b, cv, h + 2 * r, w + 2 * r)
    for n in range(k * k):
        dy, dx = divmod(n, k)
        out[:, :, dy:dy + h, dx:dx + w] += gf * (idx == n)[:, None]
    return out[..., r:r + h, r:r + w].contiguous()


def local_aggregate_backward_flops(mode: str, b: int, h: int, w: int,
                                   cd: int, cv: int, r: int) -> int:
    """f32 operations of one backward, 2 per multiply-add: the smooth modes
    recompute the window's distances (Cd) and dots with g (Cv), and sum dx
    (Cd), dy_dist (Cd) and dy_val (Cv) over it; nearest adds each
    position's g to one key (Cv)."""
    if mode == "nearest":
        return b * h * w * cv
    return 2 * b * h * w * (2 * r + 1) ** 2 * (3 * cd + 2 * cv)


def _backward_launch(fn, mode: str, x, y_dist, y_val, g, r: int, *extra):
    """(dx, dy_dist, dy_val) from the query-side and key-side kernels of
    local_agg_bwd.cu (their window products on the tensor cores in 3xTF32,
    softmax's distances on the CUDA cores in f32); one count on ``fn`` for
    the pair.  The [B, k*k, H, W] scratch of w and G is the wrapper's."""
    if x.device.type != "cuda":
        raise RuntimeError(f"no {fn.__name__} for device {x.device}")
    b, cd, h, w = x.shape
    cv = y_val.shape[1]
    if not 0 <= r <= MAX_RADIUS or not 1 <= cd <= MAX_DIST_CHANNELS:
        raise ValueError(f"{fn.__name__}: the kernel takes 0 <= r <= "
                         f"{MAX_RADIUS} and 1 <= Cd <= {MAX_DIST_CHANNELS}")
    kernels.check_inputs(fn.__name__, (x, y_dist, y_val, g))
    kk = (2 * r + 1) ** 2
    wbuf = torch.empty(b, kk, h, w, device=x.device)
    gbuf = torch.empty(b, kk, h, w, device=x.device)
    d_x, d_yd = torch.empty_like(x), torch.empty_like(y_dist)
    d_yv = torch.empty_like(y_val)
    entry = f"local_{mode}_agg_bwd_f32"
    kernels.check(kernels.entry(entry)(
        x.data_ptr(), y_dist.data_ptr(), y_val.data_ptr(), g.data_ptr(),
        wbuf.data_ptr(), gbuf.data_ptr(), d_x.data_ptr(), d_yd.data_ptr(),
        d_yv.data_ptr(), b, cd, cv, h, w, r, *extra,
        kernels.stream(x.get_device())), entry)
    fn.launches += 1
    fn.flops += local_aggregate_backward_flops(mode, b, h, w, cd, cv, r)
    return d_x, d_yd, d_yv


def local_sigmoid_aggregate_backward(x, y_dist, y_val, g, r: int):
    """(dx, dy_dist, dy_val) of the sigmoid mode for upstream ``g``."""
    if x.device.type == "cpu":
        return local_sigmoid_aggregate_backward_plain(x, y_dist, y_val, g, r)
    return _backward_launch(local_sigmoid_aggregate_backward, "sigmoid", x,
                            y_dist, y_val, g, r)


def local_softmax_aggregate_backward(x, y_dist, y_val, g, r: int,
                                     temp: float = 3.0):
    """(dx, dy_dist, dy_val) of the softmax mode for upstream ``g``."""
    if x.device.type == "cpu":
        return local_softmax_aggregate_backward_plain(x, y_dist, y_val, g, r,
                                                      temp)
    return _backward_launch(local_softmax_aggregate_backward, "softmax", x,
                            y_dist, y_val, g, r, float(temp))


def local_nearest_aggregate_backward(idx, g, r: int):
    """dy_val of the nearest mode: ``g`` gathered to the keys ``idx``
    (int32 on the card, the forward kernel's) picked."""
    fn = local_nearest_aggregate_backward
    if g.device.type == "cpu":
        return local_nearest_aggregate_backward_plain(idx, g, r)
    if g.device.type != "cuda":
        raise RuntimeError(f"no {fn.__name__} for device {g.device}")
    b, cv, h, w = g.shape
    if not 0 <= r <= MAX_RADIUS:
        raise ValueError(f"{fn.__name__}: the kernel takes 0 <= r <= "
                         f"{MAX_RADIUS}")
    kernels.check_inputs(fn.__name__, (g,))
    if (idx.dtype != torch.int32 or not idx.is_contiguous()
            or idx.shape != (b, h, w) or idx.device != g.device):
        raise ValueError(f"{fn.__name__}: idx must be contiguous int32 "
                         f"[B, H, W] on {g.device}")
    d_yv = torch.empty_like(g)
    entry = "local_nearest_agg_bwd_f32"
    kernels.check(kernels.entry(entry)(
        idx.data_ptr(), g.data_ptr(), d_yv.data_ptr(), b, cv, h, w, r,
        kernels.stream(g.get_device())), entry)
    fn.launches += 1
    fn.flops += local_aggregate_backward_flops("nearest", b, h, w, 0, cv, r)
    return d_yv


class _SigmoidAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y_dist, y_val, r):
        ctx.save_for_backward(x, y_dist, y_val)
        ctx.r = r
        return local_sigmoid_aggregate(x, y_dist, y_val, r)

    @staticmethod
    def backward(ctx, g):
        return (*local_sigmoid_aggregate_backward(
            *ctx.saved_tensors, g.contiguous(), ctx.r), None)


class _SoftmaxAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y_dist, y_val, r, temp):
        ctx.save_for_backward(x, y_dist, y_val)
        ctx.r, ctx.temp = r, temp
        return local_softmax_aggregate(x, y_dist, y_val, r, temp)

    @staticmethod
    def backward(ctx, g):
        return (*local_softmax_aggregate_backward(
            *ctx.saved_tensors, g.contiguous(), ctx.r, ctx.temp), None, None)


def local_nearest_aggregate_index(x, y_dist, y_val, r: int):
    """(out, idx) of the nearest mode for training, idx [B, H, W] each
    position's window offset dy * k + dx: on the card the forward kernel
    with its index buffer (int32), on the CPU the plain argmax (int64).
    The backward gathers through this idx, so both use one argmax."""
    if x.device.type == "cpu":
        idx = local_nearest_index_plain(x, y_dist, r)
        return local_nearest_aggregate_plain(x, y_dist, y_val, r,
                                             idx=idx), idx
    idx = torch.empty(x.shape[0], *x.shape[2:], dtype=torch.int32,
                      device=x.device)
    return _launch(local_nearest_aggregate, "nearest", x, y_dist, y_val, r,
                   *x.shape[2:], idx=idx), idx


class _NearestAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y_dist, y_val, r):
        out, idx = local_nearest_aggregate_index(x, y_dist, y_val, r)
        ctx.save_for_backward(idx)
        ctx.mark_non_differentiable(idx)
        ctx.r = r
        return out, idx

    @staticmethod
    def backward(ctx, g, _):
        (idx,) = ctx.saved_tensors
        return (None, None,
                local_nearest_aggregate_backward(idx, g.contiguous(), ctx.r),
                None)


def _trains(fn, valid_hw, *tensors) -> bool:
    """Whether the call is recorded for autograd; raises for a valid size
    (bucketed eval) then."""
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        return False
    if valid_hw is not None:
        raise ValueError(f"{fn.__name__}: a valid size is eval only (the "
                         "bucketed paths run under torch.inference_mode()); "
                         "training runs at exact shapes")
    return True


def local_sigmoid_aggregate(x, y_dist, y_val, r: int, valid_hw=None):
    """Sigmoid-weighted window mean (the default mode of our_warp)."""
    if _trains(local_sigmoid_aggregate, valid_hw, x, y_dist, y_val):
        return _SigmoidAggregate.apply(x, y_dist, y_val, r)
    hv, wv = _valid_size(local_sigmoid_aggregate, x, valid_hw)
    if x.device.type == "cpu":
        return local_sigmoid_aggregate_plain(x, y_dist, y_val, r, valid_hw)
    return _launch(local_sigmoid_aggregate, "sigmoid", x, y_dist, y_val, r,
                   hv, wv)


def local_softmax_aggregate(x, y_dist, y_val, r: int, temp: float = 3.0,
                            valid_hw=None):
    """Inverse-distance softmax window aggregation (``--distsoftmax``)."""
    if _trains(local_softmax_aggregate, valid_hw, x, y_dist, y_val):
        return _SoftmaxAggregate.apply(x, y_dist, y_val, r, temp)
    hv, wv = _valid_size(local_softmax_aggregate, x, valid_hw)
    if x.device.type == "cpu":
        return local_softmax_aggregate_plain(x, y_dist, y_val, r, temp,
                                             valid_hw)
    return _launch(local_softmax_aggregate, "softmax", x, y_dist, y_val, r,
                   hv, wv, float(temp))


def local_nearest_aggregate(x, y_dist, y_val, r: int, valid_hw=None):
    """y_val at the window's argmax distance (``--distnearest``)."""
    if _trains(local_nearest_aggregate, valid_hw, x, y_dist, y_val):
        return _NearestAggregate.apply(x, y_dist, y_val, r)[0]
    hv, wv = _valid_size(local_nearest_aggregate, x, valid_hw)
    if x.device.type == "cpu":
        return local_nearest_aggregate_plain(x, y_dist, y_val, r, valid_hw)
    return _launch(local_nearest_aggregate, "nearest", x, y_dist, y_val, r,
                   hv, wv)


#: each kernel's launches, and their f32 operations
#: (:func:`local_aggregate_flops`, :func:`local_aggregate_backward_flops`);
#: a backward of sigmoid or softmax counts once for its two kernels
for _fn in (local_sigmoid_aggregate, local_softmax_aggregate,
            local_nearest_aggregate, local_sigmoid_aggregate_backward,
            local_softmax_aggregate_backward,
            local_nearest_aggregate_backward):
    _fn.launches = 0
    _fn.flops = 0

"""Width-bucketed eval: masked NCHW ops with host-int valid sizes (JAX
counterpart: ops/masked.py).

VSPW-480p eval frames are 480 x a width that varies across videos.  Bucketed
eval pads every frame bottom/right to a small set of sizes (width to a
multiple of the bucket, height to the encoder stride, 32) and passes the TRUE
size beside it.  Predictions on the valid region equal the unpadded run's:

* Only spatial (kernel > 1x1) ops carry pad-band values into the valid
  region.  BatchNorm, ReLU, residual adds and 1x1 convs are pointwise, so the
  band only has to be zero on the INPUT of each spatial conv:
  :func:`masked_trunk` re-zeros it there, and bare spatial functions (the
  stem max pool, the GRU passes, InstanceNorm's statistics) read
  :func:`current_mask` themselves.  Trunk outputs are not masked: callers
  mask what they feed to anything but the ``*_rt`` ops.
* The valid size of a feature map follows the ratio rule
  ceil(valid_in * size_feat / size_pad), exact for the stride pyramid while
  the pad is a multiple of the total stride.
* Global ops (adaptive pooling, bilinear resize) depend on the true size:
  the ``*_rt`` ops build the unpadded run's matrices at the padded shape with
  exact integer bin and tap math, zero beyond the valid extent.

In eager PyTorch the true size is a Python int, so nothing here makes a
device scalar or synchronises.  The re-zero itself is ``ops/band_zero.py``:
in place, the kernel on the card, its plain version on the CPU.  In place is
safe because no valid-region value depends on a pad-band value: only the
masks and the ``*_rt`` matrices read the band, and they read it as zero.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import numpy as np
import torch
from torch import nn

from .band_zero import band_zero


def ceil_div(a: int, b: int) -> int:
    return -((-a) // b)


def feature_valid(hf: int, wf: int, valid_hw, pad_hw) -> tuple[int, int]:
    """Valid (rows, cols) of an [..., hf, wf] feature map, from the
    input-resolution valid and padded sizes (ratio rule)."""
    hv, wv = valid_hw
    hp, wp = pad_hw
    return ceil_div(hv * hf, hp), ceil_div(wv * wf, wp)


def bucket_size(size: int, multiple: int = 64) -> int:
    """Smallest multiple of ``multiple`` >= size."""
    return ceil_div(size, multiple) * multiple


def bucket_hw(h: int, w: int, bucket: int = 64,
              stride: int = 32) -> tuple[int, int]:
    """Padded size of a frame: width to a multiple of ``bucket``, height
    only to the encoder ``stride`` (VSPW-480p heights are one constant per
    orientation, so 480 stays 480).  (-h) % 8 <= (-h) % 32, so the slack
    always holds RAFT's symmetric /8 pad."""
    return bucket_size(h, stride), bucket_size(w, bucket)


def pad_to(x: torch.Tensor, pad_hw) -> torch.Tensor:
    """Zero-pad [..., H, W] bottom/right to ``pad_hw``: a new contiguous
    tensor (NCHW for an NCHW or permuted HWC view), whatever ``x``'s
    strides."""
    hp, wp = pad_hw
    h, w = x.shape[-2:]
    out = x.new_zeros(*x.shape[:-2], hp, wp)
    out[..., :h, :w] = x
    return out


def mask_valid(x: torch.Tensor, valid_hw) -> torch.Tensor:
    """Zero rows >= hv and columns >= wv of the last two dims of ``x``, in
    place (B6, ``ops/band_zero.py``); returns ``x``.  NCHW activations and
    [B, P, Hl, Wl] pyramid levels alike."""
    h, w = x.shape[-2:]
    return band_zero(x, min(int(valid_hw[0]), h), min(int(valid_hw[1]), w))


#: the JAX package keeps a separate last-two-dims mask for the correlation
#: levels; in NCHW both are the same function
mask_valid_hw2 = mask_valid


def _linear_weights_rt(in_pad: int, out_pad: int, in_valid: int,
                       out_valid: int, align_corners: bool) -> np.ndarray:
    """[out_pad, in_pad] torch-linear-interpolation matrix of the valid
    sizes (JAX ``_linear_weights_rt``): the top-left [out_valid, in_valid]
    block equals ``linear_weights(in_valid, out_valid)`` up to one f32
    rounding of the fraction; zero elsewhere.  Tap indices by exact integer
    floor division."""
    rows = np.arange(out_pad, dtype=np.int64)[:, None]
    cols = np.arange(in_pad, dtype=np.int64)[None, :]
    if align_corners:
        den = max(out_valid - 1, 1)
        num = rows * (in_valid - 1)
    else:
        den = 2 * out_valid
        num = np.maximum((2 * rows + 1) * in_valid - out_valid, 0)
    x0 = np.minimum(num // den, in_valid - 1)
    x1 = np.minimum(x0 + 1, in_valid - 1)
    lam = (num - x0 * den).astype(np.float32) / np.float32(den)
    w = (cols == x0) * (np.float32(1.0) - lam) + (cols == x1) * lam
    return np.where(rows < out_valid, w, np.float32(0.0)).astype(np.float32)


def _adaptive_pool_weights_rt(in_pad: int, out_size: int,
                              in_valid: int) -> np.ndarray:
    """[out_size, in_pad] torch adaptive-avg-pool bin matrix over the valid
    prefix (exact integer bin math)."""
    rows = np.arange(out_size, dtype=np.int64)[:, None]
    cols = np.arange(in_pad, dtype=np.int64)[None, :]
    start = (rows * in_valid) // out_size
    end = -((-(rows + 1) * in_valid) // out_size)
    inside = (cols >= start) & (cols < end)
    return (inside / (end - start).astype(np.float32)).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _matrix(make, args: tuple, device: torch.device) -> torch.Tensor:
    """``make(*args)`` on ``device``, built and copied once: a copy from
    pageable host memory on every call would make the host wait for the
    stream to drain.  A normal tensor even when first asked for under
    inference mode, so later callers outside it can use it too."""
    with torch.inference_mode(False):
        return torch.from_numpy(make(*args)).to(device)


def _separable(x: torch.Tensor, make, args_h: tuple, args_w: tuple):
    """wh @ x @ ww^T over the last two dims of [N, C, H, W], in f32, rows
    first (the JAX einsum order); contiguous output."""
    y = torch.matmul(_matrix(make, args_h, x.device), x.float())
    return torch.matmul(y, _matrix(make, args_w, x.device).t())


def _nearest_weights_rt(in_pad: int, out_pad: int, in_valid: int,
                        out_valid: int) -> np.ndarray:
    """[out_pad, in_pad] torch-legacy nearest matrix of the valid sizes (JAX
    ``_nearest_weights_rt``): row i < out_valid selects column
    min(floor(i * in_valid / out_valid), in_valid - 1); the other rows are
    zero."""
    rows = np.arange(out_pad, dtype=np.int64)[:, None]
    cols = np.arange(in_pad, dtype=np.int64)[None, :]
    src = np.minimum((rows * in_valid) // out_valid, in_valid - 1)
    return ((rows < out_valid) & (cols == src)).astype(np.float32)


def resize_nearest_rt(x: torch.Tensor, out_pad_hw, in_valid_hw,
                      out_valid_hw) -> torch.Tensor:
    """Nearest resize of [N, C, H, W] to ``out_pad_hw`` whose valid region
    equals the legacy-nearest resize of x's valid region to
    ``out_valid_hw``, exactly (one-hot products); zero beyond it.  The
    source index depends on the true sizes, which is why the padded grid
    alone cannot give it."""
    h, w = x.shape[-2:]
    return _separable(
        x, _nearest_weights_rt,
        (h, out_pad_hw[0], int(in_valid_hw[0]), int(out_valid_hw[0])),
        (w, out_pad_hw[1], int(in_valid_hw[1]), int(out_valid_hw[1]))).to(
            x.dtype)


def resize_bilinear_rt(x: torch.Tensor, out_pad_hw, in_valid_hw,
                       out_valid_hw, align_corners: bool = False):
    """Bilinear resize of [N, C, H, W] to ``out_pad_hw`` whose valid region
    equals resizing x's valid region to ``out_valid_hw``; zero beyond it.
    x's band is never read."""
    h, w = x.shape[-2:]
    return _separable(
        x, _linear_weights_rt,
        (h, out_pad_hw[0], int(in_valid_hw[0]), int(out_valid_hw[0]),
         align_corners),
        (w, out_pad_hw[1], int(in_valid_hw[1]), int(out_valid_hw[1]),
         align_corners)).to(x.dtype)


def adaptive_avg_pool2d_rt(x: torch.Tensor, output_size,
                           in_valid_hw) -> torch.Tensor:
    """Adaptive average pool of [N, C, H, W] over its valid region to
    ``output_size``: equals pooling the unpadded tensor."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    h, w = x.shape[-2:]
    return _separable(
        x, _adaptive_pool_weights_rt,
        (h, output_size[0], int(in_valid_hw[0])),
        (w, output_size[1], int(in_valid_hw[1]))).to(x.dtype)


def global_avg_pool_rt(x: torch.Tensor, in_valid_hw,
                       keepdim: bool = True) -> torch.Tensor:
    """Mean over the valid region of [N, C, H, W] whose band is zero."""
    hv, wv = in_valid_hw
    s = x.float().sum(dim=(2, 3), keepdim=keepdim)
    return (s / float(hv * wv)).to(x.dtype)


_MASK_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "vspw_torch_mask_ctx", default=None)


@contextlib.contextmanager
def mask_context(valid_hw, pad_hw):
    """Make (valid_hw, pad_hw), at input resolution, the
    :func:`current_mask` for the ops inside: each derives its own
    feature-level valid size by the ratio rule."""
    token = _MASK_CTX.set(((int(valid_hw[0]), int(valid_hw[1])),
                           (int(pad_hw[0]), int(pad_hw[1]))))
    try:
        yield
    finally:
        _MASK_CTX.reset(token)


def current_mask():
    """(valid_hw, pad_hw) of the enclosing :func:`mask_context`, or None."""
    return _MASK_CTX.get()


def mask_current(x: torch.Tensor) -> torch.Tensor:
    """Re-zero the band of [..., h, w] ``x`` under the enclosing mask
    context (its feature-level valid size by the ratio rule); ``x`` as it is
    outside one."""
    ctx = current_mask()
    if ctx is None:
        return x
    return mask_valid(x, feature_valid(x.shape[-2], x.shape[-1], *ctx))


def _spatial(conv: nn.Conv2d) -> bool:
    return any(k > 1 for k in conv.kernel_size)


def _mask_input_hook(_module, args):
    mask_current(args[0])


@contextlib.contextmanager
def masked_trunk(module, valid_hw, pad_hw):
    """Run ``module`` (a module or a sequence of them) width-bucketed: for
    the length of the context every ``nn.Conv2d`` of it whose kernel is
    larger than 1x1 re-zeros its input's band (a forward pre-hook, in
    place), and :func:`current_mask` is set for the bare spatial functions.
    The counterpart of the JAX package's ``masked_trunk`` (flax
    ``intercept_methods``)."""
    modules = [module] if isinstance(module, nn.Module) else module
    handles = [m.register_forward_pre_hook(_mask_input_hook)
               for mod in modules for m in mod.modules()
               if isinstance(m, nn.Conv2d) and _spatial(m)]
    try:
        with mask_context(valid_hw, pad_hw):
            yield
    finally:
        for hd in handles:
            hd.remove()


def masked_encode(encoder: nn.Module, x: torch.Tensor, valid_hw=None):
    """``encoder(x)`` width-bucketed (eval only, under inference mode): the
    trunk under :func:`masked_trunk`, then every level's band re-zeroed
    (the JAX window models' masked trunk).  An encoder that resizes between
    its levels (``resizes_across_levels``: HRNet's fusion upsamples) also
    gets ``valid_hw`` and ``pad_hw`` (JAX models/segmentation.py:42-47).
    Returns (levels, the feature valid size of the last level); (levels,
    None) at exact shapes, when ``valid_hw`` is None.  A head that reads
    levels of several strides derives each one's valid size from
    ``valid_hw`` and the padded input size by :func:`feature_valid`."""
    if valid_hw is None:
        return encoder(x), None
    pad_hw = tuple(x.shape[-2:])
    kw = ({"valid_hw": valid_hw, "pad_hw": pad_hw}
          if getattr(encoder, "resizes_across_levels", False) else {})
    with masked_trunk(encoder, valid_hw, pad_hw):
        levels = encoder(x, **kw)
    levels = [mask_valid(lv, feature_valid(*lv.shape[-2:], valid_hw, pad_hw))
              for lv in levels]
    return levels, feature_valid(*levels[-1].shape[-2:], valid_hw, pad_hw)


def feature_mask(module, feat_valid, feat_hw):
    """:func:`masked_trunk` of a head whose spatial convs all sit on one
    feature grid ``feat_hw`` (the padded grid is the feature grid, so the
    valid size is ``feat_valid`` itself); nothing when ``feat_valid`` is
    None."""
    if feat_valid is None:
        return contextlib.nullcontext()
    return masked_trunk(module, feat_valid, feat_hw)

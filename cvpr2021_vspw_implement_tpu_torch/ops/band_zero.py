"""In-place re-zero of the width-bucketed pad band: the CUDA kernel and its
plain version (JAX counterparts: ops/pallas/band_zero.py::band_zero_inplace
and ops/masked.py::mask_valid).

For x [..., H, W] and valid sizes hv <= H, wv <= W: rows [hv, H) of every
plane and columns [wv, W) of rows [0, hv) become zero; nothing else is
touched.  It writes in place, so it is for eval only: a tensor that requires
grad is refused.  With no band (hv = H and wv = W) nothing is launched.

A CPU tensor takes the plain version; a CUDA tensor launches
``kernels/csrc/band_zero.cu``.
"""

from __future__ import annotations

import torch

from .. import kernels


def band_zero_plain(x: torch.Tensor, hv: int, wv: int) -> torch.Tensor:
    x[..., hv:, :] = 0
    x[..., :hv, wv:] = 0
    return x


def band_zero(x: torch.Tensor, hv: int, wv: int) -> torch.Tensor:
    """Zero the pad band of ``x`` beyond (hv, wv), in place; returns ``x``."""
    if x.dim() < 2:
        raise ValueError("band_zero takes a tensor [..., H, W]")
    h, w = x.shape[-2:]
    if not (0 <= hv <= h and 0 <= wv <= w):
        raise ValueError(f"band_zero: valid size ({hv}, {wv}) outside "
                         f"({h}, {w})")
    if x.requires_grad:
        raise ValueError("band_zero writes in place: it takes no tensor that "
                         "requires grad (run under torch.inference_mode())")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("band_zero: the tensor must be contiguous float32")
    if (hv == h and wv == w) or x.numel() == 0:
        return x
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise RuntimeError(f"no band_zero for device {x.device}")
        return band_zero_plain(x, hv, wv)
    planes = x.numel() // (h * w)
    if planes * h >= 2 ** 31 or h * w >= 2 ** 31:
        raise ValueError("band_zero: the kernel indexes rows and planes in "
                         "32 bits: planes * H and H * W must stay below 2^31")
    kernels.check(kernels.entry("band_zero_f32")(
        x.data_ptr(), planes, h, w, hv, wv, kernels.stream(x.get_device())),
        "band_zero_f32")
    band_zero.launches += 1
    return x


band_zero.launches = 0

"""Host helpers: device choice, and copies of the JAX package's
utils/misc.py running average, logger and PNG palette."""

from __future__ import annotations

import logging
import sys

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  CUDA is the default and is never
    replaced by the CPU: asking for it without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu "
                           "(device='cpu') to run on the CPU")
    return dev


class AverageMeter:
    """Running average (reference: utils.py:135-167)."""

    def __init__(self):
        self.val = None
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, weight: float = 1.0):
        self.val = val
        self.sum += val * weight
        self.count += weight

    def value(self):
        return self.val

    def average(self):
        return self.sum / self.count if self.count else None


def setup_logger(distributed_rank: int = 0, filename: str = "log.txt"):
    """Stdout logger (reference: utils.py:110-122)."""
    logger = logging.getLogger("Logger")
    logger.setLevel(logging.DEBUG)
    if distributed_rank > 0 or logger.handlers:
        return logger
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setLevel(logging.DEBUG)
    fmt = "[%(asctime)s %(levelname)s %(filename)s line %(lineno)d %(process)d] %(message)s"
    ch.setFormatter(logging.Formatter(fmt))
    logger.addHandler(ch)
    return logger


def vspw_palette() -> list[int]:
    """The 256-entry PNG palette of the prediction dumps (test.py:22):
    entries 0-21 the VOC bit-pattern colormap with the 192 level replaced
    by 191, entries 22-255 grayscale (i, i, i)."""
    def voc_color(i: int):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        return [min(v, 191) if v == 192 else v for v in (r, g, b)]

    palette: list[int] = []
    for i in range(22):
        palette.extend(voc_color(i))
    for i in range(22, 256):
        palette.extend([i, i, i])
    return palette

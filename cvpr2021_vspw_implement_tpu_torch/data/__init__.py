from .datasets import (TestFrameDataset, list_frames, list_videos, load_frame,
                       normalize_image, remap_label)
from .synthetic import make_synthetic_vspw

__all__ = ["TestFrameDataset", "list_frames", "list_videos", "load_frame",
           "normalize_image", "remap_label", "make_synthetic_vspw"]

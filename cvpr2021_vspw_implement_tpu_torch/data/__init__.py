from .datasets import (ClipDataset, LongClipDataset, TestClipDataset,
                       TestFrameDataset, list_frames, list_videos, load_frame,
                       normalize_image, remap_label)
from .loader import ClipLoader, make_collate_target_last
from .synthetic import make_synthetic_vspw

__all__ = ["ClipDataset", "ClipLoader", "LongClipDataset", "TestClipDataset",
           "TestFrameDataset", "list_frames", "list_videos", "load_frame",
           "make_collate_target_last", "normalize_image", "remap_label",
           "make_synthetic_vspw"]

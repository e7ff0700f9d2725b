from .datasets import (ClipDataset, FrameDataset, LongClipDataset,
                       TestClipDataset, TestFrameDataset, list_frames,
                       list_videos, load_frame, normalize_image, remap_label)
from .loader import (PrefetchLoader, collate_clip_frames, collate_frames,
                     make_collate_target_last)
from .synthetic import make_synthetic_vspw

__all__ = ["ClipDataset", "FrameDataset", "LongClipDataset", "PrefetchLoader",
           "TestClipDataset", "TestFrameDataset", "collate_clip_frames",
           "collate_frames", "list_frames", "list_videos", "load_frame",
           "make_collate_target_last", "normalize_image", "remap_label",
           "make_synthetic_vspw"]

from .optim import create_clip_optimizer, create_frame_optimizer, poly_schedule
from .train_state import (device_prefetch, pinned_collate, to_device,
                          train_step)

__all__ = ["create_clip_optimizer", "create_frame_optimizer",
           "device_prefetch", "pinned_collate", "poly_schedule", "to_device",
           "train_step"]

from .optim import create_clip_optimizer, poly_schedule
from .train_state import to_device, train_step

__all__ = ["create_clip_optimizer", "poly_schedule", "to_device",
           "train_step"]

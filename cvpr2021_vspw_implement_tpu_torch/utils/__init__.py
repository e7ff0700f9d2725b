from .metrics import Evaluator, get_common, pixel_acc, video_consistency
from .misc import AverageMeter, resolve_device, setup_logger, vspw_palette

__all__ = ["AverageMeter", "Evaluator", "get_common", "pixel_acc",
           "resolve_device", "setup_logger", "video_consistency",
           "vspw_palette"]

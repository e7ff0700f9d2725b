from .metrics import Evaluator, get_common, pixel_acc
from .misc import AverageMeter, resolve_device, setup_logger, vspw_palette

__all__ = ["AverageMeter", "Evaluator", "get_common", "pixel_acc",
           "resolve_device", "setup_logger", "vspw_palette"]

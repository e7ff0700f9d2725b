from .metrics import Evaluator, get_common
from .misc import resolve_device, setup_logger, vspw_palette

__all__ = ["Evaluator", "get_common", "resolve_device", "setup_logger",
           "vspw_palette"]

from .defaults import cfg, check_compute_dtype
from .node import CfgNode

__all__ = ["cfg", "CfgNode", "check_compute_dtype"]

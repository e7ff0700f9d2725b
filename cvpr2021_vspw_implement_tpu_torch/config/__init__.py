from .defaults import cfg
from .node import CfgNode

__all__ = ["cfg", "CfgNode"]

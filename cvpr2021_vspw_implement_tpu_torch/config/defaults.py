"""Default configuration tree: the parts the eval drivers read (mirrors
the JAX package's config/defaults.py, which mirrors the reference yacs
surface).  The YAML presets in ``presets/`` merge on top."""

from .node import CfgNode as CN

_C = CN()
_C.DIR = "ckpt/vspw-resnet50dilated-ppm_deepsup"

_C.DATASET = CN()
_C.DATASET.root_dataset = "./data/"
_C.DATASET.num_class = 150

_C.MODEL = CN()
_C.MODEL.arch_encoder = "resnet50dilated"
_C.MODEL.arch_decoder = "ppm_deepsup"
_C.MODEL.fc_dim = 2048

cfg = _C

"""Default configuration tree: the parts the entry points read (mirrors
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
# reference torch checkpoints for the pretrained init (pretrained.py); the
# train_clip flags --pre_enc / --pre_dec take precedence
_C.MODEL.weights_encoder = ""
_C.MODEL.weights_decoder = ""

_C.TRAIN = CN()
_C.TRAIN.batch_size_per_gpu = 2
_C.TRAIN.num_epoch = 20
_C.TRAIN.start_epoch = 0
_C.TRAIN.epoch_iters = 5000
_C.TRAIN.optim = "SGD"
_C.TRAIN.lr_encoder = 0.02
_C.TRAIN.lr_decoder = 0.02
_C.TRAIN.lr_pow = 0.9
_C.TRAIN.beta1 = 0.9
_C.TRAIN.weight_decay = 1e-4
_C.TRAIN.deep_sup_scale = 0.4
_C.TRAIN.fix_bn = False
_C.TRAIN.workers = 16
_C.TRAIN.disp_iter = 20
_C.TRAIN.seed = 304

# the section keeps the JAX package's name so that its KEY VALUE overrides
# carry over; the port reads three keys of it
_C.TPU = CN()
# batches the trainers' loader collates ahead, and copies to the card ahead
# (data/loader.py, parallel/train_state.py::device_prefetch)
_C.TPU.prefetch = 2
# RAFT refinements of the frozen-flow methods (the reference hard-codes 20)
_C.TPU.raft_iters = 20
# the JAX CLIs default to bfloat16; the port computes in float32 only, and
# its CLIs refuse any other value (check_compute_dtype)
_C.TPU.compute_dtype = "float32"

cfg = _C


def check_compute_dtype(cfg) -> None:
    """Raise unless ``cfg.TPU.compute_dtype`` is float32, the only compute
    type the port has: an override such as ``TPU.compute_dtype bfloat16``
    must not run float32 without a word."""
    dtype = cfg.TPU.compute_dtype
    if dtype != "float32":
        raise ValueError(f"TPU.compute_dtype {dtype!r} is not ported: the "
                         "port computes in float32 only (pass "
                         "TPU.compute_dtype float32)")

"""Carry weights from the JAX package's variable trees into port modules.

``load_jax_variables(model, variables)`` takes a Flax ``{"params",
"batch_stats"}`` tree as nested dicts of numpy arrays (a ``ClipPSP``, a
``RAFT``, an ``ETC`` or a ``ClipWarpNet`` one, training heads included) and
fills the port module: conv kernels HWIO → OIHW, BN
scale/bias/mean/var → weight/bias/running_mean/running_var, free parameters
(our_warp's ``w{i}``) as they are.  It is the
inverse of the JAX package's ``models/import_torch.py`` importers, which
read a port ``state_dict()`` back, since the port keeps the reference's
torch parameter names.  Every parameter and buffer of the module must be
found in the tree; anything missing raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from .models.clip_psp import ClipPSP
from .models.etc import ETC
from .models.raft import RAFT
from .models.warp_our import ClipWarpNet

# (port module name pattern, Flax path template) — BN paths name the node
# holding scale/bias (params) and mean/var (batch_stats); conv paths the
# node holding kernel/bias
_RESNET = [
    (r"(conv\d)", r"\1/conv"),
    (r"(bn\d)", r"\1"),
    (r"layer(\d)\.(\d+)\.(conv\d)", r"layer\1_\2/\3/conv"),
    (r"layer(\d)\.(\d+)\.(bn\d)", r"layer\1_\2/\3"),
    (r"layer(\d)\.(\d+)\.downsample\.0", r"layer\1_\2/downsample_conv/conv"),
    (r"layer(\d)\.(\d+)\.downsample\.1", r"layer\1_\2/downsample_bn"),
]
_CLIP_PSP = [(r"encoder\." + p, "encoder/" + t) for p, t in _RESNET] + [
    (r"ppm_conv\.ppm\.(\d+)\.0", r"ppm_convs_\1/conv/conv"),
    (r"ppm_conv\.ppm\.(\d+)\.1", r"ppm_convs_\1/bn"),
    (r"ppm_conv\.conv_last_\.0", "conv_last_conv/conv"),
    (r"ppm_conv\.conv_last_\.1", "conv_last_bn"),
    (r"ppm_conv\.conv_last_\.4", "conv_last_cls/conv"),
    (r"deepsup\.0", "deepsup_conv/conv"),
    (r"deepsup\.1", "deepsup_bn"),
    (r"deepsup\.4", "deepsup_cls/conv"),
    (r"pspweight_conv\.0", "pspweight_conv/conv"),
]
_RAFT = [
    (r"([fc]net)\.(conv\d)", r"\1/\2/conv"),
    (r"([fc]net)\.norm1", r"\1/norm1/bnorm"),
    (r"([fc]net)\.layer(\d)\.(\d)\.(conv\d)", r"\1/layer\2_\3/\4/conv"),
    (r"([fc]net)\.layer(\d)\.(\d)\.(norm\d)", r"\1/layer\2_\3/\4/bnorm"),
    (r"([fc]net)\.layer(\d)\.(\d)\.downsample\.0",
     r"\1/layer\2_\3/downsample/conv"),
    (r"([fc]net)\.layer(\d)\.(\d)\.downsample\.1", r"\1/layer\2_\3/norm3/bnorm"),
    (r"update_block\.encoder\.(\w+)", r"update_block/encoder/\1/conv"),
    (r"update_block\.gru\.(\w+)", r"update_block/gru/\1"),
    (r"update_block\.flow_head\.(\w+)", r"update_block/flow_head/\1/conv"),
    (r"update_block\.mask\.(\d)", r"update_block/mask_\1/conv"),
]
_ENCODER_DECODER = [(r"encoder\." + p, "encoder/" + t) for p, t in _RESNET] + [
    (r"decoder\.ppm\.(\d+)\.1", r"decoder/ppm/ppm_\1_conv/conv"),
    (r"decoder\.ppm\.(\d+)\.2", r"decoder/ppm/ppm_\1_bn"),
    (r"decoder\.conv_last_\.0", "decoder/conv_last_/0/conv"),
    (r"decoder\.conv_last_\.1", "decoder/conv_last_/1"),
    (r"decoder\.cbr_deepsup\.0", "decoder/cbr_deepsup/0/conv"),
    (r"decoder\.cbr_deepsup\.1", "decoder/cbr_deepsup/1"),
    (r"decoder\.conv_last_deepsup_", "decoder/conv_last_deepsup_/conv"),
]
_ETC = [(r"raft\." + p, "raft/" + t) for p, t in _RAFT] + _ENCODER_DECODER + [
    (r"conv_last_\.0", "conv_last_0/conv"),
    (r"conv_last_\.1", "conv_last_1"),
    (r"conv_last_\.4", "conv_last_cls/conv"),
]
_CLIP_WARP = _ENCODER_DECODER + [
    (r"prop_clip\.(emb|emb_2)\.0", r"prop_clip/\1/0/conv"),
    (r"prop_clip\.(emb|emb_2)\.1", r"prop_clip/\1/1"),
    (r"prop_clip\.(w\d+)", r"prop_clip/\1"),
    (r"prop_clip\.last_layer\.1", "prop_clip/last_conv/conv"),
    (r"last_layer\.1", "last_layer/conv"),
]
_RULES = {ClipPSP: _CLIP_PSP, RAFT: _RAFT, ETC: _ETC, ClipWarpNet: _CLIP_WARP}


def _flax_path(name: str, rules) -> list[str]:
    for pat, tmpl in rules:
        if re.fullmatch(pat, name):
            return re.sub(pat, tmpl, name).split("/")
    raise KeyError(f"no Flax path for port module {name!r}")


def _get(tree: dict, path: list[str]) -> dict:
    for p in path:
        if p not in tree:
            raise KeyError("/".join(path))
        tree = tree[p]
    return tree


def _copy(dst: torch.Tensor, src) -> None:
    src = torch.from_numpy(np.asarray(src, np.float32).copy())
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} vs {tuple(dst.shape)}")
    dst.copy_(src)


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables: dict) -> nn.Module:
    """Fill ``model`` (ClipPSP, RAFT, ETC or ClipWarpNet) from a Flax
    variable tree; returns the model."""
    rules = _RULES.get(type(model))
    if rules is None:
        raise TypeError(f"no JAX layout known for {type(model).__name__}")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            node = _get(params, _flax_path(name, rules))
            _copy(m.weight, np.transpose(np.asarray(node["kernel"]),
                                         (3, 2, 0, 1)))
            if m.bias is not None:
                _copy(m.bias, node["bias"])
        elif isinstance(m, nn.BatchNorm2d):
            path = _flax_path(name, rules)
            _copy(m.weight, _get(params, path)["scale"])
            _copy(m.bias, _get(params, path)["bias"])
            _copy(m.running_mean, _get(stats, path)["mean"])
            _copy(m.running_var, _get(stats, path)["var"])
        else:
            for pname, p in m.named_parameters(prefix=name, recurse=False):
                _copy(p, _get(params, _flax_path(pname, rules)))
    return model

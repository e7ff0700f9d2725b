"""Carry weights from the JAX package's variable trees into port modules.

``load_jax_variables(model, variables)`` takes a Flax ``{"params",
"batch_stats"}`` tree as nested dicts of numpy arrays (a ``ClipPSP``, a
``ClipOCRNet``, a ``RAFT``, a ``NetWarp`` or an ``ETC`` with either
decoder, a ``ClipWarpNet``, a ``NonLocal3D``, a ``TD4PSP``, a
``SegmentationModule`` or a ``SegmentationModuleClip`` one, training heads
included, or a trunk or a per-frame head alone) and fills the port module
(a per-frame ``SegmentationModule`` with any encoder and decoder of
``models.builder``, its rules chosen by the encoder's and the decoder's
type): conv kernels HWIO → OIHW (a grouped kernel's I is cin / groups, so
[kh, kw, cin / groups, O] → [O, cin / groups, kh, kw]), the
Dense kernels [in, out] of the 1x1 convs that the JAX package runs as
products (the non-local block's projections, TDNet's attention ``fc``) →
[out, in, 1, ...], BN scale/bias/mean/var → weight/bias/running_mean/
running_var, LayerNorm scale/bias → weight/bias, free parameters (our_warp's
``w{i}``, NetWarp's ``w0_*`` / ``w1_*``) as they are.  It is the
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

from .models.clip_ocr import ClipOCRNet
from .models.clip_psp import ClipPSP
from .models.deeplab import DeepLab
from .models.decoders import UPerNet
from .models.etc import ETC
from .models.hrnet import HRNetV2
from .models.hrnet_clip import HRNetV2Clip, SegmentationModuleClip
from .models.mobilenet import MobileNetV2Dilated
from .models.netwarp import NetWarp
from .models.nonlocal3d import NonLocal3D
from .models.nonlocal_blocks import NonLocal2d
from .models.ocr import SpatialOCRNet
from .models.raft import RAFT
from .models.resnet import ResNetFeatures
from .models.segmentation import SegmentationModule
from .models.td4_psp import TD4PSP
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
# HRNetV2 (JAX ``stem`` and ``stages``); stage s's transition is the
# reference's transition{s-1}, a new branch one Sequential deeper
_HRNET = [
    (r"conv([12])", r"stem/stem\1/conv/conv"),
    (r"bn([12])", r"stem/stem\1/bn"),
    (r"layer1\.(\d)\.(conv\d)", r"stem/layer1_\1/\2/conv"),
    (r"layer1\.(\d)\.(bn\d)", r"stem/layer1_\1/\2"),
    (r"layer1\.(\d)\.downsample\.0",
     r"stem/layer1_\1/downsample_conv/conv"),
    (r"layer1\.(\d)\.downsample\.1", r"stem/layer1_\1/downsample_bn"),
    *[rule for t in (1, 2, 3) for rule in [
        (rf"transition{t}\.(\d)\.(?:0\.)?0",
         rf"stages/transition{t + 1}_\1/conv/conv"),
        (rf"transition{t}\.(\d)\.(?:0\.)?1",
         rf"stages/transition{t + 1}_\1/bn")]],
    (r"stage(\d)\.(\d)\.branches\.(\d)\.(\d)\.(conv\d)",
     r"stages/stage\1_m\2/branch\3_block\4/\5/conv"),
    (r"stage(\d)\.(\d)\.branches\.(\d)\.(\d)\.(bn\d)",
     r"stages/stage\1_m\2/branch\3_block\4/\5"),
    (r"stage(\d)\.(\d)\.fuse_layers\.(\d)\.(\d)\.0",
     r"stages/stage\1_m\2/fuse\3_\4/conv/conv"),
    (r"stage(\d)\.(\d)\.fuse_layers\.(\d)\.(\d)\.1",
     r"stages/stage\1_m\2/fuse\3_\4/bn"),
    (r"stage(\d)\.(\d)\.fuse_layers\.(\d)\.(\d)\.(\d)\.0",
     r"stages/stage\1_m\2/fuse\3_\4_\5/conv/conv"),
    (r"stage(\d)\.(\d)\.fuse_layers\.(\d)\.(\d)\.(\d)\.1",
     r"stages/stage\1_m\2/fuse\3_\4_\5/bn"),
]
_HRNET_CLIP = _HRNET + [(r"time_atten\.conv1", "time_atten/conv1/conv")]
# the per-frame decoders: C1 (cbr, conv_last_1), C1DeepSup (cbr,
# conv_last_, cbr_deepsup, conv_last_deepsup_), PPM (ppm, conv_last) and
# PPMDeepsup (ppm, conv_last_, cbr_deepsup, conv_last_deepsup_); OCRNet's
# are _OCR_NET below
_FRAME_DECODERS = [
    (r"decoder\.ppm\.(\d+)\.1", r"decoder/ppm/ppm_\1_conv/conv"),
    (r"decoder\.ppm\.(\d+)\.2", r"decoder/ppm/ppm_\1_bn"),
    (r"decoder\.(conv_last_?)\.0", r"decoder/\1/0/conv"),
    (r"decoder\.(conv_last_?)\.1", r"decoder/\1/1"),
    (r"decoder\.(conv_last_?)\.4", r"decoder/\1/cls/conv"),
    (r"decoder\.(cbr|cbr_deepsup)\.0", r"decoder/\1/0/conv"),
    (r"decoder\.(cbr|cbr_deepsup)\.1", r"decoder/\1/1"),
    (r"decoder\.(conv_last_|conv_last_1|conv_last_deepsup_)",
     r"decoder/\1/conv"),
]
# the OCR head (models/ocr.py) under the JAX package's names
_OCB = r"spatial_ocr_head\.object_context_block\."
_OCR_HEAD = [
    (r"conv_3x3\.0", "conv_3x3_conv/conv"),
    (r"conv_3x3\.1", "conv_3x3_bn"),
    (_OCB + r"f_pixel\.0", "spatial_ocr_head/object_context_block/"
     "f_pixel_0_conv/conv"),
    (_OCB + r"f_pixel\.1", "spatial_ocr_head/object_context_block/"
     "f_pixel_0_bn"),
    (_OCB + r"f_pixel\.3", "spatial_ocr_head/object_context_block/"
     "f_pixel_1_conv/conv"),
    (_OCB + r"f_pixel\.4", "spatial_ocr_head/object_context_block/"
     "f_pixel_1_bn"),
    (_OCB + r"(f_object|f_down)\.0",
     r"spatial_ocr_head/object_context_block/\1/conv0/conv"),
    (_OCB + r"(f_object|f_down)\.1",
     r"spatial_ocr_head/object_context_block/\1/bn0"),
    (_OCB + r"f_object\.3",
     "spatial_ocr_head/object_context_block/f_object/conv1/conv"),
    (_OCB + r"f_object\.4", "spatial_ocr_head/object_context_block/"
     "f_object/bn1"),
    (_OCB + r"f_up\.0", "spatial_ocr_head/object_context_block/f_up_conv/"
     "conv"),
    (_OCB + r"f_up\.1", "spatial_ocr_head/object_context_block/f_up_bn"),
    (r"spatial_ocr_head\.conv_bn_dropout\.0",
     "spatial_ocr_head/fuse_conv/conv"),
    (r"spatial_ocr_head\.conv_bn_dropout\.1", "spatial_ocr_head/fuse_bn"),
]
# SpatialOCRAsDec, the decoder of netwarp_ocr and etc_ocr
_OCR_DECODER = [(r"decoder\." + p, "decoder/" + t) for p, t in _OCR_HEAD] + [
    (r"decoder\.dsn_head\.0", "decoder/dsn_head_cbr/0/conv"),
    (r"decoder\.dsn_head\.1", "decoder/dsn_head_cbr/1"),
    (r"decoder\.dsn_head\.4", "decoder/dsn_cls/conv"),
]
# SpatialOCRNet, the per-frame OCRNet decoder
_OCR_NET = _OCR_DECODER + [(r"decoder\.head", "decoder/head/conv")]
_DECODERS = _FRAME_DECODERS + _OCR_NET


def _under(prefix: str, rules):
    """``rules`` of a submodule named ``prefix`` (its Flax node too)."""
    return [(prefix + r"\." + p, prefix + "/" + t) for p, t in rules]


# MobileNetV2: the stem and the inverted residual blocks, whose Sequential
# indices 0/1, 3/4, 6/7 are the JAX package's conv_/bn_ 0, 1, 2
_MOBILENET = [
    (r"features\.0\.0", "stem_conv/conv"),
    (r"features\.0\.1", "stem_bn"),
    *[(rf"features\.(\d+)\.conv\.{3 * j}", rf"block_\1/conv_{j}/conv")
      for j in range(3)],
    *[(rf"features\.(\d+)\.conv\.{3 * j + 1}", rf"block_\1/bn_{j}")
      for j in range(3)],
]
_UPERNET = [
    (r"ppm_conv\.(\d+)\.0", r"ppm_conv_\1_conv/conv"),
    (r"ppm_conv\.(\d+)\.1", r"ppm_conv_\1_bn"),
    (r"ppm_last_conv\.0", "ppm_last_conv/0/conv"),
    (r"ppm_last_conv\.1", "ppm_last_conv/1"),
    (r"fpn_in\.(\d+)\.0", r"fpn_in_\1_conv/conv"),
    (r"fpn_in\.(\d+)\.1", r"fpn_in_\1_bn"),
    (r"fpn_out\.(\d+)\.0\.0", r"fpn_out_\1/0/conv"),
    (r"fpn_out\.(\d+)\.0\.1", r"fpn_out_\1/1"),
    (r"conv_last_\.0\.0", "conv_last_0/0/conv"),
    (r"conv_last_\.0\.1", "conv_last_0/1"),
    (r"conv_last_\.1", "conv_last_1/conv"),
]
_DEEPLAB = [
    (r"aspp\.(aspp\d)\.atrous_conv", r"aspp/\1/conv/conv"),
    (r"aspp\.(aspp\d)\.bn", r"aspp/\1/bn"),
    (r"aspp\.global_avg_pool\.1", "aspp/gp_conv/conv"),
    (r"aspp\.global_avg_pool\.2", "aspp/gp_bn"),
    (r"aspp\.conv1", "aspp/conv1/conv"),
    (r"aspp\.bn1", "aspp/bn1"),
    (r"decoder\.conv1", "low_conv/conv"),
    (r"decoder\.bn1", "low_bn"),
    (r"decoder\.last_conv\.0", "last_conv_0/conv"),
    (r"decoder\.last_conv\.1", "last_bn_0"),
    (r"decoder\.last_conv\.4", "last_conv_1/conv"),
    (r"decoder\.last_conv\.5", "last_bn_1"),
    (r"decoder\.lastlast_conv\.1", "classifier/conv"),
]
# the 2D and the 3D non-local heads: the block's projections are Dense
_NONLOCAL_HEAD = [
    (r"(emb|last_layer)", r"\1/conv"),
    (r"nonlocalblock\.(g|theta|phi)", r"nonlocalblock/\1"),
    (r"nonlocalblock\.W_z\.0", "nonlocalblock/W_z"),
    (r"nonlocalblock\.W_z\.1", "nonlocalblock/W_z_bn"),
]
#: a per-frame model's rules by its encoder's and its decoder's type (the
#: ResNets and the per-frame decoders of _DECODERS otherwise)
_ENCODER_RULES = {HRNetV2: _HRNET, MobileNetV2Dilated: _MOBILENET}
_DECODER_RULES = {UPerNet: _UPERNET, DeepLab: _DEEPLAB,
                  NonLocal2d: _NONLOCAL_HEAD}
_CLIP_OCR = [(r"encoder\." + p, "encoder/" + t) for p, t in _RESNET] + \
    _OCR_HEAD + [
    (r"dsn_head\.0", "dsn_conv/conv"),
    (r"dsn_head\.1", "dsn_bn"),
    (r"dsn_head\.4", "dsn_cls/conv"),
    (r"head", "head/conv"),
]
_ETC = [(r"raft\." + p, "raft/" + t) for p, t in _RAFT] + _ENCODER_DECODER + \
    _OCR_DECODER + [
    (r"conv_last_\.0", "conv_last_0/conv"),
    (r"conv_last_\.1", "conv_last_1"),
    (r"conv_last_\.4", "conv_last_cls/conv"),
    (r"conv_last_", "conv_last_cls/conv"),            # etc_ocr's classifier
]
_NETWARP = _ETC + [
    (r"flowcnn\.(conv\d)\.0", r"flowcnn/\1/0/conv"),
    (r"flowcnn\.(conv\d)\.1", r"flowcnn/\1/1"),
    (r"head", "head/conv"),                           # netwarp_ocr's
    (r"(w[01]_[01])", r"\1"),
]
_CLIP_WARP = _ENCODER_DECODER + [
    (r"prop_clip\.(emb|emb_2)\.0", r"prop_clip/\1/0/conv"),
    (r"prop_clip\.(emb|emb_2)\.1", r"prop_clip/\1/1"),
    (r"prop_clip\.(w\d+)", r"prop_clip/\1"),
    (r"prop_clip\.last_layer\.1", "prop_clip/last_conv/conv"),
    (r"last_layer\.1", "last_layer/conv"),
]
_NONLOCAL3D = _under("encoder", _RESNET) + _NONLOCAL_HEAD
# TDNet's path i (1-4) is the JAX package's list entry i - 1
_TD4 = [rule for i in range(1, 5) for rule in [
    (rf"pretrained{i}\." + p, f"paths_{i - 1}/" + t) for p, t in _RESNET] + [
    (rf"psp{i}\.(conv\d)\.0", rf"psps_{i - 1}/\1_conv/conv"),
    (rf"psp{i}\.(conv\d)\.1", rf"psps_{i - 1}/\1_bn"),
    (rf"enc{i}\.(w_[qk]s)\.(\d)\.conv", rf"encs_{i - 1}/\1_\2/conv/conv"),
    (rf"enc{i}\.(w_[qk]s)\.0\.bn", rf"encs_{i - 1}/\1_0/bn"),
    (rf"enc{i}\.w_vs\.0\.conv", f"encs_{i - 1}/w_vs/conv/conv"),
    (rf"layer_norm{i}\.ln", f"lns_{i - 1}"),
    (rf"head{i}\.conv5\.0", f"heads_{i - 1}/conv/conv"),
    (rf"head{i}\.conv5\.1", f"heads_{i - 1}/bn"),
    (rf"head{i}\.conv5\.4", f"heads_{i - 1}/cls/conv"),
    (rf"auxlayer{i}\.conv5\.0", f"auxs_{i - 1}/conv/conv"),
    (rf"auxlayer{i}\.conv5\.1", f"auxs_{i - 1}/bn"),
    (rf"auxlayer{i}\.conv5\.4", f"auxs_{i - 1}/cls/conv"),
]] + [(rf"atn{a}_{b}\.fc\.0\.conv", f"atns_{a - 1}_{b - 1}/fc")
      for a in range(1, 5) for b in range(1, 5) if a != b]
_RULES = {ClipPSP: _CLIP_PSP, ClipOCRNet: _CLIP_OCR, RAFT: _RAFT, ETC: _ETC,
          NetWarp: _NETWARP, ClipWarpNet: _CLIP_WARP,
          NonLocal3D: _NONLOCAL3D, TD4PSP: _TD4, HRNetV2Clip: _HRNET_CLIP,
          ResNetFeatures: _RESNET, **_ENCODER_RULES, **_DECODER_RULES,
          SpatialOCRNet: [(p.removeprefix(r"decoder\."),
                           t.removeprefix("decoder/")) for p, t in _OCR_NET],
          SegmentationModuleClip: _under("encoder", _HRNET_CLIP) + _DECODERS}


def _rules(model: nn.Module):
    """The rules of ``model``: a per-frame ``SegmentationModule``'s by its
    encoder's and its decoder's type."""
    if isinstance(model, SegmentationModule):
        dec = _DECODER_RULES.get(type(model.decoder))
        return (_under("encoder", _ENCODER_RULES.get(type(model.encoder),
                                                     _RESNET))
                + (_DECODERS if dec is None else _under("decoder", dec)))
    return _RULES.get(type(model))


def _flax_path(name: str, rules) -> list[str]:
    for pat, tmpl in rules:
        m = re.fullmatch(pat, name)
        if m:
            return m.expand(tmpl).split("/")
    raise KeyError(f"no Flax path for port module {name!r}")


def _get(tree: dict, path: list[str]) -> dict:
    for p in path:
        if p not in tree:
            raise KeyError("/".join(path))
        tree = tree[p]
    return tree


def _copy(dst: torch.Tensor, src) -> None:
    """``src`` into ``dst`` at ``dst``'s precision: a float64 model takes a
    float64 tree without a pass through float32."""
    dtype = np.float64 if dst.dtype == torch.float64 else np.float32
    src = torch.from_numpy(np.asarray(src, dtype).copy())
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} vs {tuple(dst.shape)}")
    dst.copy_(src)


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables: dict) -> nn.Module:
    """Fill ``model`` (ClipPSP, ClipOCRNet, RAFT, ETC, NetWarp, ClipWarpNet,
    NonLocal3D, TD4PSP, SegmentationModule, SegmentationModuleClip,
    HRNetV2Clip, or a trunk or per-frame head of ``_RULES`` alone) from a
    Flax variable tree; returns the model."""
    rules = _rules(model)
    if rules is None:
        raise TypeError(f"no JAX layout known for {type(model).__name__}")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            node = _get(params, _flax_path(name, rules))
            kernel = np.asarray(node["kernel"])
            if kernel.ndim == 2:            # a Dense kernel [in, out]
                kernel = kernel.T.reshape(m.weight.shape)
            else:
                kernel = np.transpose(kernel, (3, 2, 0, 1))
            _copy(m.weight, kernel)
            if m.bias is not None:
                _copy(m.bias, node["bias"])
        elif isinstance(m, nn.LayerNorm):
            node = _get(params, _flax_path(name, rules))
            _copy(m.weight, node["scale"])
            _copy(m.bias, node["bias"])
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            path = _flax_path(name, rules)
            _copy(m.weight, _get(params, path)["scale"])
            _copy(m.bias, _get(params, path)["bias"])
            _copy(m.running_mean, _get(stats, path)["mean"])
            _copy(m.running_var, _get(stats, path)["var"])
        else:
            for pname, p in m.named_parameters(prefix=name, recurse=False):
                _copy(p, _get(params, _flax_path(pname, rules)))
    return model

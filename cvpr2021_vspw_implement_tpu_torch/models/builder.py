"""String-keyed model factory (JAX counterpart: models/builder.py; reference
models/models.py:512-656): the reference's ``arch_encoder`` /
``arch_decoder`` names onto the port's modules.  Names the port has no
module for raise, naming the ROADMAP item (Queue A) that ports them.
"""

from __future__ import annotations

from torch import nn

from . import decoders
from .hrnet import HRNetV2
from .ocr import SpatialOCRNet
from .resnet import build_encoder as build_resnet

#: the encoders and decoders that the port does not have yet, by the
#: ROADMAP Queue A item that ports them
_NOT_PORTED = {
    **dict.fromkeys(("mobilenetv2dilated", "resnext101", "resnet18",
                     "resnet50", "resnet101"), 7),
    **dict.fromkeys(("upernet", "upernet_lite", "deeplab", "nonlocal2d"), 7),
}


def _refuse(kind: str, arch: str, known) -> None:
    item = _NOT_PORTED.get(arch)
    if item is not None:
        raise NotImplementedError(
            f"{kind} {arch!r} is not ported yet (ROADMAP Queue A item "
            f"{item}); the port has {sorted(known)}")
    raise ValueError(f"unknown {kind} {arch!r}; the port has "
                     f"{sorted(known)}")


class ModelBuilder:
    ENCODERS = ("resnet18dilated", "resnet50dilated", "resnet101dilated",
                "hrnetv2")
    DECODERS = ("c1", "c1_deepsup", "ppm", "ppm_deepsup",
                "ppm_deepsup_clip", "ppm_clip", "ocrnet_deepsup")

    @staticmethod
    def build_encoder(arch: str = "resnet50dilated") -> nn.Module:
        """The trunk: the dilated ResNets' [C2, C3, C4, C5] (output stride
        8), HRNetV2's one 720-channel map (output stride 4).  The clip
        encoder ``hrnetv2_clip`` takes a (target, clips) pair: the method
        ``hrnetv2_clip`` builds it (methods.py)."""
        arch = arch.lower()
        if arch == "hrnetv2":
            return HRNetV2()
        if arch == "hrnetv2_clip":
            raise ValueError(
                "encoder 'hrnetv2_clip' takes a (target, clips) pair, which "
                "a per-frame model cannot feed: evaluate it with test_clip "
                "--method hrnetv2_clip")
        if arch not in ModelBuilder.ENCODERS:
            _refuse("encoder", arch, ModelBuilder.ENCODERS)
        return build_resnet(arch)

    @staticmethod
    def build_decoder(arch: str = "ppm_deepsup", fc_dim: int = 512,
                      num_class: int = 150) -> nn.Module:
        arch = arch.lower()
        if arch == "c1":
            return decoders.C1(num_class, fc_dim)
        if arch == "c1_deepsup":
            return decoders.C1DeepSup(num_class, fc_dim)
        if arch == "ppm":
            return decoders.PPM(num_class, fc_dim)
        if arch == "ppm_deepsup":
            return decoders.PPMDeepsup(num_class, fc_dim)
        if arch == "ppm_deepsup_clip":
            return decoders.PPMDeepsupClip(num_class, fc_dim)
        if arch == "ppm_clip":
            return decoders.PPMClip(fc_dim)
        if arch == "ocrnet_deepsup":
            return SpatialOCRNet(num_class, fc_dim)
        _refuse("decoder", arch, ModelBuilder.DECODERS)

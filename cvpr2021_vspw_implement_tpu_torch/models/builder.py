"""String-keyed model factory (JAX counterpart: models/builder.py; reference
models/models.py:512-656): the reference's ``arch_encoder`` /
``arch_decoder`` names onto the port's modules.  Every name of the JAX
package's ``ModelBuilder`` is built; the clip encoder ``hrnetv2_clip``
raises here, naming the CLI that builds it, and an unknown name raises
``ValueError``.
"""

from __future__ import annotations

from torch import nn

from . import decoders
from .deeplab import DeepLab
from .hrnet import HRNetV2
from .mobilenet import MobileNetV2Dilated
from .nonlocal_blocks import NonLocal2d
from .ocr import SpatialOCRNet
from .resnet import ARCHS as RESNETS
from .resnet import build_encoder as build_resnet


class ModelBuilder:
    ENCODERS = (*RESNETS, "mobilenetv2dilated", "hrnetv2")
    DECODERS = ("c1", "c1_deepsup", "ppm", "ppm_deepsup",
                "ppm_deepsup_clip", "ppm_clip", "upernet", "upernet_lite",
                "deeplab", "nonlocal2d", "ocrnet_deepsup")

    @staticmethod
    def build_encoder(arch: str = "resnet50dilated") -> nn.Module:
        """The trunk: a ResNet's or ResNeXt's [C2, C3, C4, C5] (output
        stride 8 for the ``*dilated`` names, else 32), MobileNetV2's five
        levels (output stride 8), HRNetV2's one 720-channel map (output
        stride 4).  The clip encoder ``hrnetv2_clip`` takes a (target,
        clips) pair: the method ``hrnetv2_clip`` builds it (methods.py)."""
        arch = arch.lower()
        if arch == "hrnetv2":
            return HRNetV2()
        if arch == "mobilenetv2dilated":
            return MobileNetV2Dilated()
        if arch == "hrnetv2_clip":
            raise ValueError(
                "encoder 'hrnetv2_clip' takes a (target, clips) pair, which "
                "a per-frame model cannot feed: evaluate it with test_clip "
                "--method hrnetv2_clip")
        if arch not in RESNETS:
            raise ValueError(f"unknown encoder {arch!r}; the port has "
                             f"{sorted(ModelBuilder.ENCODERS)}")
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
        if arch in ("upernet", "upernet_lite"):
            return decoders.UPerNet(num_class, fc_dim,
                                    fpn_dim=256 if arch == "upernet_lite"
                                    else 512)
        if arch == "deeplab":
            return DeepLab(num_class, fc_dim)
        if arch == "nonlocal2d":
            return NonLocal2d(num_class, fc_dim)
        if arch == "ocrnet_deepsup":
            return SpatialOCRNet(num_class, fc_dim)
        raise ValueError(f"unknown decoder {arch!r}; the port has "
                         f"{sorted(ModelBuilder.DECODERS)}")

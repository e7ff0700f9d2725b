"""Reference torch checkpoints loaded into the port's encoders and decoders
(JAX counterpart: models/import_torch.py::apply_pretrained_init and the
per-frame eval's ``--torch_enc`` / ``--torch_dec``; reference
train_clip2.py:511-512, ``ModelBuilder(weights=)``).

The paper's recipe starts temporal training from per-frame-pretrained
weights: ``--pre_enc`` (or ``cfg.MODEL.weights_encoder``) is a reference
torch encoder checkpoint, loaded into ``model.encoder``; ``--pre_dec`` (or
``cfg.MODEL.weights_decoder``) a reference decoder checkpoint, loaded into
``model.decoder``.  Both load with ``strict=False`` as the JAX package
overlays them (``merge_variables``): a parameter the checkpoint lacks keeps
its init, and a checkpoint entry the model lacks (a per-frame classifier, a
``fc``) is dropped.  A method without a decoder (``clip_psp``) logs that
``--pre_dec`` is ignored.

The port keeps the reference's torch names, so a checkpoint loads as it
is, but for what the JAX importers rename (``import_resnet_state_dict``,
``import_ppm_decoder_state_dict``): the ``module.`` prefix of a
DataParallel checkpoint goes, ``num_batches_tracked`` is dropped, and a
per-frame ``PPMDeepsup``'s ``conv_last`` / ``conv_last_deepsup`` are the
clip decoder's ``conv_last_`` / ``conv_last_deepsup_`` (``conv_last`` only
for a ``deepsup`` decoder arch, as the importer's ``deepsup`` flag).  An
encoder checkpoint drops the classification head that the JAX importer
skips too (``ENCODER_HEADS``): HRNet's (``import_hrnet_state_dict``), a
ResNet's or ResNeXt's ``fc`` (``import_resnet_state_dict``), MobileNetV2's
``features.18`` and classifier (``import_mobilenet_state_dict``).  The
new heads (UPerNet, DeepLab, Non-local 2D) keep the reference's names.
"""

from __future__ import annotations

import torch

from .models.hrnet import HRNetV2
from .models.mobilenet import MobileNetV2Dilated
from .models.resnet import ResNetFeatures

#: the reference HRNet's classification head, which the segmentation trunk
#: has no place for (JAX models/import_torch.py:250-252)
HRNET_HEADS = ("incre_modules", "downsamp_modules", "final_layer",
               "classifier", "last_layer")
#: the classification heads of an encoder checkpoint, by the trunk's type
#: (JAX models/import_torch.py:119, :266-297)
ENCODER_HEADS = {HRNetV2: HRNET_HEADS,
                 ResNetFeatures: ("fc", "fc_1", "avgpool"),
                 MobileNetV2Dilated: ("features.18", "classifier")}


def reference_renamed(state_dict, heads=None, drop=()) -> dict:
    """``state_dict`` without the ``module.`` prefix, the
    ``num_batches_tracked`` counters and the entries under a name of
    ``drop``, the first name component mapped through ``heads``."""
    heads = heads or {}
    out = {}
    for name, t in state_dict.items():
        name = name.removeprefix("module.")
        head, dot, rest = name.partition(".")
        if name.endswith("num_batches_tracked") or any(
                name.startswith(d + ".") for d in drop):
            continue
        out[heads.get(head, head) + dot + rest] = t
    return out


def _decoder_heads(arch_decoder: str) -> dict:
    """Per-frame decoder names → the clip decoder's, for ``arch_decoder``."""
    deepsup = "deepsup" in arch_decoder.lower()
    return {"conv_last": "conv_last_" if deepsup else "conv_last",
            "conv_last_deepsup": "conv_last_deepsup_"}


def load_reference_weights(model, cfg, encoder: str = "", decoder: str = "",
                           strict: bool = True, logger=None):
    """Load the reference checkpoints ``encoder`` / ``decoder`` (paths, ""
    for none) into ``model.encoder`` / ``model.decoder``, renamed as above.
    ``strict``: every parameter and buffer of the module must come from the
    checkpoint and every entry of it must land (``num_batches_tracked``
    aside); otherwise a missing one keeps its init and an extra one is
    dropped.  Returns ``model``."""
    for part, path in (("encoder", encoder), ("decoder", decoder)):
        if not path:
            continue
        module = getattr(model, part, None)
        if module is None:
            if logger:
                logger.info(f"reference {part} {path} ignored — this "
                            f"model has no {part}")
            continue
        heads = _decoder_heads(cfg.MODEL.arch_decoder) \
            if part == "decoder" else None
        drop = ENCODER_HEADS.get(type(module), ()) \
            if part == "encoder" else ()
        missing, unexpected = module.load_state_dict(
            reference_renamed(torch.load(path, map_location="cpu"), heads,
                              drop),
            strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if strict and (missing or unexpected):
            raise KeyError(f"{part} checkpoint {path}: missing {missing}, "
                           f"unexpected {unexpected}")
        if logger:
            logger.info(f"reference {part} loaded from {path}")
    return model


def apply_pretrained_init(model, cfg, args, logger=None):
    """Load ``--pre_enc`` / ``--pre_dec`` (or ``cfg.MODEL.weights_encoder``
    / ``weights_decoder``) into ``model`` in place, after its init and
    before the optimizer is built; returns ``model``."""
    return load_reference_weights(
        model, cfg, getattr(args, "pre_enc", "") or cfg.MODEL.weights_encoder,
        getattr(args, "pre_dec", "") or cfg.MODEL.weights_decoder,
        strict=False, logger=logger)

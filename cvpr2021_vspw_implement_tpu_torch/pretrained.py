"""Pretrained init of the temporal trainer (JAX counterpart:
models/import_torch.py::apply_pretrained_init; reference train_clip2.py:
511-512, ``ModelBuilder(weights=)``).

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
for a ``deepsup`` decoder arch, as the importer's ``deepsup`` flag).
"""

from __future__ import annotations

import torch


def _renamed(state_dict, heads=None) -> dict:
    """``state_dict`` without the ``module.`` prefix and the
    ``num_batches_tracked`` counters, its first name component mapped
    through ``heads``."""
    heads = heads or {}
    out = {}
    for name, t in state_dict.items():
        name = name.removeprefix("module.")
        if name.endswith("num_batches_tracked"):
            continue
        head, dot, rest = name.partition(".")
        out[heads.get(head, head) + dot + rest] = t
    return out


def _decoder_heads(arch_decoder: str) -> dict:
    """Per-frame decoder names → the clip decoder's, for ``arch_decoder``."""
    deepsup = "deepsup" in arch_decoder.lower()
    return {"conv_last": "conv_last_" if deepsup else "conv_last",
            "conv_last_deepsup": "conv_last_deepsup_"}


def apply_pretrained_init(model, cfg, args, logger=None):
    """Load ``--pre_enc`` / ``--pre_dec`` (or ``cfg.MODEL.weights_encoder``
    / ``weights_decoder``) into ``model`` in place, after its init and
    before the optimizer is built; returns ``model``."""
    pre_enc = getattr(args, "pre_enc", "") or cfg.MODEL.weights_encoder
    pre_dec = getattr(args, "pre_dec", "") or cfg.MODEL.weights_decoder
    if pre_enc:
        model.encoder.load_state_dict(
            _renamed(torch.load(pre_enc, map_location="cpu")), strict=False)
        if logger:
            logger.info(f"pretrained init: encoder from {pre_enc}")
    if pre_dec:
        decoder = getattr(model, "decoder", None)
        if decoder is None:
            if logger:
                logger.info("pretrained init: --pre_dec ignored — this "
                            "method has no decoder")
        else:
            decoder.load_state_dict(
                _renamed(torch.load(pre_dec, map_location="cpu"),
                         _decoder_heads(cfg.MODEL.arch_decoder)),
                strict=False)
            if logger:
                logger.info(f"pretrained init: decoder from {pre_dec}")
    return model

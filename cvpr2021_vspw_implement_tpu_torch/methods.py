"""Temporal-method registry: model factory, loss and batch collation per
``--method`` (JAX counterpart: methods.py; reference dispatch
train_clip2.py:264-321).

Each entry builds a module with the ``(imgs [T+1, B, 3, H, W] target last)
-> outputs`` convention and a loss ``(outputs, batch) -> (loss, acc)``.
Every method of the JAX clip trainer is ported, train and eval:
``clip_psp``, ``clip_ocr``, ``netwarp``, ``netwarp_ocr``, ``ETC``,
``etc_ocr``, ``our_warp``, ``propnet``, ``our_warp_merge``, ``tdnet`` and
``nonlocal3d``; and ``hrnetv2_clip``, which the JAX package evaluates and
whose loss it has, but which its clip trainer does not offer (JAX
config/args.py:12-15), nor does the port's.
"""

from __future__ import annotations

from functools import partial

from .data.loader import collate_clips_in_order, make_collate_target_last

LONGCLIP_METHODS = ("clip_psp", "clip_ocr")
#: methods that take every clip frame in order, none singled out as target
ALLFRAME_METHODS = ("tdnet", "nonlocal3d")


def _build_clip_psp(cfg, args):
    from .models.clip_psp import build_clip_psp, clip_psp_loss
    model = build_clip_psp(cfg, args.num_class,
                           psp_weight=getattr(args, "psp_weight", False))
    return model, partial(clip_psp_loss,
                          deep_sup_scale=getattr(args, "deepsup_scale", 0.4))


def _build_clip_ocr(cfg, args):
    from .models.clip_ocr import build_clip_ocr, clip_ocr_loss
    clipocr_all = getattr(args, "clipocr_all", False)
    model = build_clip_ocr(cfg, args.num_class, clipocr_all=clipocr_all)
    return model, partial(clip_ocr_loss,
                          deep_sup_scale=getattr(args, "deepsup_scale", 0.4),
                          clipocr_all=clipocr_all)


def _build_netwarp(cfg, args, ocr: bool = False):
    from .models.netwarp import build_netwarp, netwarp_loss
    if args.clip_num != 2:
        raise ValueError("netwarp needs clip_num=2 (netwarp.py:91)")
    model = build_netwarp(cfg, args.num_class, ocr=ocr,
                          raft_iters=cfg.TPU.raft_iters)
    return model, partial(netwarp_loss,
                          deep_sup_scale=getattr(args, "deepsup_scale", 0.4),
                          ocr=ocr)


def _build_etc(cfg, args, ocr: bool = False):
    from .models.etc import build_etc, etc_loss
    if args.clip_num != 2 or args.dilation_num != 0:
        raise ValueError("ETC needs clip_num=2, dilation_num=0 (ETC.py:70)")
    model = build_etc(cfg, args.num_class, raft_iters=cfg.TPU.raft_iters,
                      ocr=ocr)
    return model, partial(etc_loss,
                          deep_sup_scale=getattr(args, "deepsup_scale", 0.4),
                          st_weight=getattr(args, "st_weight", 0.1), ocr=ocr)


def _build_our_warp(cfg, args):
    from .models.warp_our import build_clip_warp, clip_warp_loss
    return build_clip_warp(cfg, args.num_class, args), partial(
        clip_warp_loss, deep_sup_scale=getattr(args, "deepsup_scale", 0.4),
        allsup=getattr(args, "allsup", False),
        allsup_scale=getattr(args, "allsup_scale", 0.3),
        fix=getattr(args, "fix", False))


def _build_propnet(cfg, args):
    from .models.propnet import build_propnet, propnet_loss
    return build_propnet(cfg, args.num_class, args), partial(
        propnet_loss, deep_sup_scale=getattr(args, "deepsup_scale", 0.4))


def _build_warp_merge(cfg, args):
    from .models.warp_our_merge import build_warp_merge, warp_merge_loss
    return build_warp_merge(cfg, args.num_class, args), partial(
        warp_merge_loss, deep_sup_scale=getattr(args, "deepsup_scale", 0.4))


def _build_nonlocal3d(cfg, args):
    from .models.nonlocal3d import build_nonlocal3d, nonlocal3d_loss
    return build_nonlocal3d(cfg, args.num_class), nonlocal3d_loss


def _build_hrnetv2_clip(cfg, args):
    """HRNetV2-clip (the TimeAtten clip encoder) and the cfg's per-frame
    decoder (JAX methods.py:141-152)."""
    from .models.builder import ModelBuilder
    from .models.hrnet_clip import (HRNetV2Clip, SegmentationModuleClip,
                                    seg_clip_loss)
    enc = HRNetV2Clip(clip_middle=getattr(args, "clip_middle", True))
    dec = ModelBuilder.build_decoder(cfg.MODEL.arch_decoder,
                                     fc_dim=cfg.MODEL.fc_dim,
                                     num_class=args.num_class)
    return SegmentationModuleClip(enc, dec), seg_clip_loss


def _build_tdnet(cfg, args):
    from .models.td4_psp import TD4PSP, td4_loss
    return TD4PSP(args.num_class,
                  cropsize=getattr(args, "cropsize", 479)), td4_loss


METHODS = {"clip_psp": _build_clip_psp, "clip_ocr": _build_clip_ocr,
           "netwarp": _build_netwarp,
           "netwarp_ocr": partial(_build_netwarp, ocr=True),
           "ETC": _build_etc, "etc_ocr": partial(_build_etc, ocr=True),
           "our_warp": _build_our_warp, "propnet": _build_propnet,
           "our_warp_merge": _build_warp_merge,
           "nonlocal3d": _build_nonlocal3d, "tdnet": _build_tdnet,
           "hrnetv2_clip": _build_hrnetv2_clip}


def get_collate(method: str, clip_num: int):
    """Batch collation per method (reference: train_clip2.py:50-82): tdnet
    and nonlocal3d keep the frames in order; long clips (clip_psp,
    clip_ocr) put the anchor, sample frame 0, last; contiguous clips (ETC,
    netwarp) the middle frame, for even ``clip_num`` the later middle."""
    if method in ALLFRAME_METHODS:
        return collate_clips_in_order
    if method in LONGCLIP_METHODS:
        return make_collate_target_last(0)
    mid = clip_num // 2 if clip_num % 2 == 0 else (clip_num - 1) // 2
    return make_collate_target_last(mid)


def build_method(method: str, cfg, args):
    """→ (model, loss_fn) with a fresh, unseeded init."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    return METHODS[method](cfg, args)

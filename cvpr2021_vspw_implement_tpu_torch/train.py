"""Per-frame trainer (JAX counterpart: train.py; reference train.py): the
per-frame baselines, e.g. PSPNet (``resnet101dilated`` + ``ppm_deepsup``) as
scripts/run_psp.sh trains it, and every other pair of ``models.builder``
(UPerNet, DeepLab and Non-local 2D give one logits map, trained without
deep supervision; C1 and PPM ``*_deepsup`` on MobileNetV2 two).

``FrameDataset`` (every ``int(15 / --trainfps)``-th frame, flip, with
``--multi_scale`` a scale, pad and a random crop, 480x720 with
``--train_filter``), or with ``--use_clipdataset`` long clips whose frames
are folded into the batch; ``PrefetchLoader`` collates on its worker thread
into pinned memory and ``device_prefetch`` copies each batch to the card
ahead of its step (depth ``TPU.prefetch``).  A step is forward, the loss
with deep supervision (``TRAIN.deep_sup_scale``), backward and the
per-frame SGD (one poly schedule, weight decay on conv kernels only,
parallel/optim.py).  As in the JAX trainer the schedule runs over
``TRAIN.epoch_iters * --totalepoch`` steps while an epoch walks the
loader's batches.  Weights are a seeded random init, then ``--pre_enc`` /
``--pre_dec`` (``MODEL.weights_encoder / decoder``) reference checkpoints
(pretrained.py); a checkpoint (``torch.save``) at each epoch's end in
``DIR``, and with ``--validation`` (the default) the per-frame eval of the
val split after training, as the reference's run_psp.sh chains it.

    python -m cvpr2021_vspw_implement_tpu_torch.train \\
        --cfg cvpr2021_vspw_implement_tpu_torch/config/presets/vsp-resnet18dilated-ppm_deepsup.yaml \\
        --dataroot DATA --batchsize 8 --cropsize 479 --lr 0.01 --device cpu
"""

from __future__ import annotations

import argparse
import os
import time
from functools import partial

import torch

from .config import check_compute_dtype
from .config import cfg as default_cfg
from .config.args import (build_train_parser, postprocess_args,
                          refuse_unported)
from .data import (FrameDataset, LongClipDataset, PrefetchLoader,
                   collate_clip_frames, collate_frames)
from .models.layers import init_weights, set_dropout_generator
from .models.segmentation import segmentation_loss
from .parallel import (create_frame_optimizer, device_prefetch,
                       pinned_collate, train_step)
from .pretrained import apply_pretrained_init
from .test import build_segmentation, evaluate
from .utils import AverageMeter, resolve_device, setup_logger
from .utils.checkpoint import save_checkpoint


def frame_loss(outs, batch, deep_sup_scale: float | None = 0.4):
    return segmentation_loss(outs, batch["label"], deep_sup_scale)


def train(cfg, args, logger=None, max_steps: int | None = None):
    """Train the per-frame model of ``cfg.MODEL``; stops after
    ``max_steps`` steps when given.  Returns the model (on
    ``args.device``, in training mode)."""
    refuse_unported(args)
    logger = logger or setup_logger()
    device = resolve_device(getattr(args, "device", "cuda"))
    seed = getattr(args, "seed", None)
    seed = cfg.TRAIN.seed if seed is None else seed
    model = build_segmentation(cfg, args.num_class)
    init_weights(model, torch.Generator().manual_seed(seed))
    apply_pretrained_init(model, cfg, args, logger)
    model.to(device).train()
    set_dropout_generator(
        model, torch.Generator(device=device).manual_seed(seed))

    if getattr(args, "use_clipdataset", False):
        dataset, collate = LongClipDataset(args, "train", seed=seed), \
            collate_clip_frames
    else:
        dataset, collate = FrameDataset(args, "train", seed=seed), \
            collate_frames
    loader = PrefetchLoader(dataset, args.batchsize,
                            pinned_collate(collate, device), seed=seed,
                            prefetch=cfg.TPU.prefetch)
    optimizer, scheduler = create_frame_optimizer(
        model, lr=args.lr, max_iters=cfg.TRAIN.epoch_iters * args.totalepoch,
        momentum=cfg.TRAIN.beta1, weight_decay=args.weight_decay,
        lr_pow=cfg.TRAIN.lr_pow)
    loss_fn = partial(frame_loss, deep_sup_scale=cfg.TRAIN.deep_sup_scale)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model params: {n_params / 1e6:.1f}M; iters/epoch: "
                f"{len(loader)}")

    batch_time, data_time = AverageMeter(), AverageMeter()
    ave_loss, ave_acc = AverageMeter(), AverageMeter()
    total_steps = 0
    for epoch in range(cfg.TRAIN.start_epoch, args.totalepoch):
        # the shuffle and FrameDataset's draws are keyed by the epoch
        loader.set_epoch(epoch)
        tic = time.time()
        # data_time: the wait for a batch on the card
        for i, batch in enumerate(device_prefetch(loader, device,
                                                  cfg.TPU.prefetch)):
            data_time.update(time.time() - tic)
            metrics = train_step(model, optimizer, scheduler, batch, loss_fn)
            loss, acc = float(metrics["loss"]), float(metrics["acc"])
            batch_time.update(time.time() - tic)
            tic = time.time()
            ave_loss.update(loss)
            ave_acc.update(acc * 100)
            if i % cfg.TRAIN.disp_iter == 0:
                logger.info(
                    f"Epoch: [{epoch}][{i}/{len(loader)}], "
                    f"Time: {batch_time.average():.2f}, "
                    f"Data: {data_time.average():.2f}, "
                    f"Loss: {ave_loss.average():.4f}, "
                    f"Acc: {ave_acc.average():.2f}")
            total_steps += 1
            if max_steps and total_steps >= max_steps:
                break
        ckpt = save_checkpoint(cfg.DIR, model, optimizer, scheduler,
                               total_steps, epoch + 1)
        logger.info(f"saved checkpoint {ckpt}")
        if max_steps and total_steps >= max_steps:
            break
    return model


def main(argv=None):
    args = build_train_parser().parse_args(argv)
    postprocess_args(args)
    refuse_unported(args)
    cfg = default_cfg.clone()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    check_compute_dtype(cfg)   # before anything is written to cfg.DIR
    cfg.DATASET.num_class = args.num_class
    cfg.TRAIN.num_epoch = args.totalepoch
    cfg.TRAIN.weight_decay = args.weight_decay
    cfg.TRAIN.lr_encoder = cfg.TRAIN.lr_decoder = args.lr
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    logger = setup_logger()
    logger.info(f"Loaded configuration file {args.cfg}")
    os.makedirs(cfg.DIR, exist_ok=True)
    with open(os.path.join(cfg.DIR, "config.yaml"), "w") as f:
        f.write(cfg.dump())
    model = train(cfg, args, logger)
    if args.validation:
        # the reference chains val inference after training (run_psp.sh)
        eval_args = argparse.Namespace(
            dataroot=args.dataroot, split="val", num_class=args.num_class,
            saveroot=args.saveroot, lesslabel=args.lesslabel,
            use_720p=False, device=args.device)
        evaluate(cfg, eval_args, model=model.eval(), logger=logger)
        model.train()
    return model


if __name__ == "__main__":
    main()

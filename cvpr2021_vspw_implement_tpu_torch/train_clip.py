"""Temporal-method trainer (JAX counterpart: train_clip.py;
reference train_clip2.py).

``--method`` dispatches over the registry in methods.py (every method of
the JAX trainer); the collate functions put the target frame last in the
stacked [T, B, ...] clip, or keep the frames in order (``tdnet``,
``nonlocal3d``).  ``tdnet`` rotates the path that owns the target, ``pos_id
= (step + 1) % 4`` (reference train_clip2.py:93-94), and logs it.
``PrefetchLoader`` collates on its worker thread into pinned memory and
``device_prefetch`` copies each batch to the card ahead of its step (depth
``TPU.prefetch``).  A step is forward, loss, backward and the clip-recipe
SGD with 0.1x encoder LR and 1x for every head, the window methods' warp
heads included (parallel/).  Weights are a seeded random init, then ``--pre_enc/--pre_dec`` (or ``MODEL.weights_encoder/
decoder``) load reference per-frame checkpoints over the encoder and the
decoder (pretrained.py), as the paper's recipe starts; checkpoints are
``torch.save`` files, every 20 epochs and at the end, and ``--resume_epoch N``
continues from ``./resume/model_epoch_N.pth`` as the reference does.
``--refrng`` draws the clips and their augmentation from the global
``random`` / ``np.random`` streams in the reference's order (``main`` seeds
``np.random`` as JAX's does).

    python -m cvpr2021_vspw_implement_tpu_torch.train_clip \\
        --cfg cvpr2021_vspw_implement_tpu_torch/config/presets/vsp-resnet18dilated-ppm_deepsup_clip.yaml \\
        --dataroot DATA --method clip_psp --clip_num 4 --dilation2 3,6,9 \\
        --batchsize 2 --cropsize 479 --lr 0.002 --device cpu
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .config import check_compute_dtype
from .config import cfg as default_cfg
from .config.args import build_train_clip_parser, postprocess_args
from .data import ClipDataset, LongClipDataset, PrefetchLoader
from .methods import LONGCLIP_METHODS, build_method, get_collate
from .models.layers import init_weights, set_dropout_generator
from .parallel import (create_clip_optimizer, device_prefetch,
                       pinned_collate, train_step)
from .pretrained import apply_pretrained_init
from .utils import AverageMeter, resolve_device, setup_logger
from .utils.checkpoint import load_checkpoint, save_checkpoint


def train_clip(cfg, args, logger=None, max_steps: int | None = None):
    """Train ``args.method``; stops after ``max_steps`` steps when given.
    Returns the model (on ``args.device``, in training mode)."""
    logger = logger or setup_logger()
    device = resolve_device(getattr(args, "device", "cuda"))
    seed = getattr(args, "seed", None)
    seed = cfg.TRAIN.seed if seed is None else seed
    model, loss_fn = build_method(args.method, cfg, args)
    init_weights(model, torch.Generator().manual_seed(seed))
    apply_pretrained_init(model, cfg, args, logger)
    model.to(device).train()
    dropout_rng = torch.Generator(device=device).manual_seed(seed)
    set_dropout_generator(model, dropout_rng)

    ds_cls = LongClipDataset if args.method in LONGCLIP_METHODS else ClipDataset
    dataset = ds_cls(args, "train", seed=seed)
    loader = PrefetchLoader(
        dataset, args.batchsize,
        pinned_collate(get_collate(args.method, args.clip_num), device),
        seed=seed, prefetch=cfg.TPU.prefetch)

    max_iters = len(loader) * args.totalepoch
    optimizer, scheduler = create_clip_optimizer(
        model, lr=args.lr, max_iters=max_iters, momentum=cfg.TRAIN.beta1,
        weight_decay=args.weight_decay, lr_pow=cfg.TRAIN.lr_pow,
        fix_encoder=args.fix)

    start_epoch, total_steps = cfg.TRAIN.start_epoch, 0
    if args.resume_epoch != 0:
        path = os.path.join("./resume", f"model_epoch_{args.resume_epoch}.pth")
        total_steps, start_epoch = load_checkpoint(path, model, optimizer,
                                                   scheduler, dropout_rng)
        logger.info(f"resume from epoch {args.resume_epoch}")

    batch_time, data_time = AverageMeter(), AverageMeter()
    ave_loss, ave_acc = AverageMeter(), AverageMeter()
    steps_run = 0
    for epoch in range(start_epoch, args.totalepoch):
        tic = time.time()
        # data_time: the wait for a batch on the card, collated on the
        # loader's thread and copied ahead on a side stream
        for i, batch in enumerate(device_prefetch(loader, device,
                                                  cfg.TPU.prefetch)):
            data_time.update(time.time() - tic)
            kw = ({"pos_id": (total_steps + 1) % 4}
                  if args.method == "tdnet" else {})
            metrics = train_step(model, optimizer, scheduler, batch, loss_fn,
                                 **kw)
            loss, acc = float(metrics["loss"]), float(metrics["acc"])
            batch_time.update(time.time() - tic)
            tic = time.time()
            ave_loss.update(loss)
            ave_acc.update(acc * 100)
            if i % cfg.TRAIN.disp_iter == 0:
                logger.info(
                    f"Epoch: [{epoch + 1}][{i}/{len(loader)}], "
                    f"Time: {batch_time.average():.2f}, "
                    f"Data: {data_time.average():.2f}, "
                    f"Accuracy: {ave_acc.average():4.2f}, "
                    f"Loss: {ave_loss.average():.6f}"
                    + (f", pos_id: {kw['pos_id']}" if kw else ""))
            total_steps += 1
            steps_run += 1
            if max_steps and steps_run >= max_steps:
                break
        # the reference checkpoints every 20 epochs (train_clip2.py:383); the
        # final epoch is saved as well
        if (epoch + 1) % 20 == 0 or (epoch + 1) == args.totalepoch:
            ckpt = save_checkpoint(args.saveroot or cfg.DIR, model, optimizer,
                                   scheduler, total_steps, epoch + 1,
                                   dropout_rng)
            logger.info(f"saved checkpoint {ckpt}")
        if (epoch + 1) % 20 == 0 and getattr(args, "validation", False):
            validate(cfg, args, model, logger)
        if max_steps and steps_run >= max_steps:
            break
    return model


def validate(cfg, args, model, logger):
    """In-training validation at each 20-epoch checkpoint (reference
    train_clip2.py:383-386): streaming for clip_psp, windows for ETC."""
    from .test_clip import evaluate_clip
    # eval-only args the train parser doesn't define
    for k, v in (("split", "val"), ("vc_clip_num", 8), ("is_save", False),
                 ("max_videos", 0)):
        if not hasattr(args, k):
            setattr(args, k, v)
    evaluate_clip(cfg, args, model=model.eval(), logger=logger)
    model.train()


def main(argv=None):
    args = build_train_clip_parser().parse_args(argv)
    postprocess_args(args)
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
    # the global stream that --refrng draws from, seeded as JAX's
    # train_clip.py seeds it
    np.random.seed(cfg.TRAIN.seed if args.seed is None else args.seed)
    return train_clip(cfg, args, logger)


if __name__ == "__main__":
    main()

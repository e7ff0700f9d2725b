"""Per-frame trainer (JAX counterpart: train.py; reference train.py): the
per-frame baselines, e.g. PSPNet (``resnet101dilated`` + ``ppm_deepsup``) as
scripts/run_psp.sh trains it, and every other pair of ``models.builder``
(UPerNet, DeepLab and Non-local 2D give one logits map, trained without
deep supervision; C1 and PPM ``*_deepsup`` on MobileNetV2 two).

``FrameDataset`` (every ``int(15 / --trainfps)``-th frame, flip, with
``--multi_scale`` a scale, pad and a random crop, 480x720 with
``--train_filter``), with ``--use_clipdataset`` long clips whose frames
are folded into the batch, or with ``--usetwodata`` a batch of the
``--batchsize`` VSPW frames then as many from ``--dataroot2``
(``TwoDataset``); ``--refrng`` draws the augmentation from the global
``random`` / ``np.random`` streams in the reference's order, ``np.random``
seeded by ``main`` as in JAX.  ``PrefetchLoader`` collates on its worker
thread into pinned memory and ``device_prefetch`` copies each batch to the
card ahead of its step (depth ``TPU.prefetch``).  A step is forward, the
loss with deep supervision (``TRAIN.deep_sup_scale``), backward and the
per-frame SGD (one poly schedule, weight decay on conv kernels only,
parallel/optim.py).  As in the JAX trainer the schedule runs over
``TRAIN.epoch_iters * --totalepoch`` steps while an epoch walks the
loader's batches.  Weights are a seeded random init, then ``--pre_enc`` /
``--pre_dec`` (``MODEL.weights_encoder / decoder``) reference checkpoints
(pretrained.py); a checkpoint (``torch.save``, utils/checkpoint.py) at
each epoch's end in ``DIR``, and with ``--validation`` (the default) the
per-frame eval of the val split after training, as the reference's
run_psp.sh chains it.  A SIGTERM or SIGINT makes the loop save
``DIR/preempt_<step>.pth`` at the next step boundary and return;
``--resume true`` restarts from the newest checkpoint in ``DIR``, at
epoch ``step // len(loader)``, making and dropping the ``step %
len(loader)`` batches that were consumed, as JAX's resumed run does.  With
``FrameDataset``'s keyed draws it then continues as the uninterrupted run
would (bitwise on the CPU; on a card only with deterministic algorithms);
the stateful streams of ``--usetwodata``, ``--refrng`` and long clips are
not saved, so after the start epoch their draws differ from the
uninterrupted run's, as in JAX.
``--profile_dir`` writes a ``torch.profiler`` Chrome trace of the run's
first steps (to step index 3, as JAX's).

    python -m cvpr2021_vspw_implement_tpu_torch.train \\
        --cfg cvpr2021_vspw_implement_tpu_torch/config/presets/vsp-resnet18dilated-ppm_deepsup.yaml \\
        --dataroot DATA --batchsize 8 --cropsize 479 --lr 0.01 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import os
from functools import partial

import numpy as np
import torch

from .config import check_compute_dtype
from .config import cfg as default_cfg
from .config.args import (build_train_parser, postprocess_args,
                          refuse_unported)
from .data import (FrameDataset, LongClipDataset, PrefetchLoader, TwoDataset,
                   collate_clip_frames, collate_frames, collate_two_frames)
from .models.layers import init_weights, set_dropout_generator
from .models.segmentation import segmentation_loss
from .parallel import (create_frame_optimizer, device_prefetch,
                       pinned_collate, train_step)
from .pretrained import apply_pretrained_init
from .test import build_segmentation, evaluate
from .utils import AverageMeter, resolve_device, setup_logger
from .utils import checkpoint
from .utils.profiling import StepTimer, annotate, trace

#: the trace of ``--profile_dir`` ends after the step of this index
#: (counted from 0 in the run), where JAX's train.py stops its trace
PROFILE_LAST_STEP = 3


def frame_loss(outs, batch, deep_sup_scale: float | None = 0.4):
    return segmentation_loss(outs, batch["label"], deep_sup_scale)


def train_dataset(args, seed: int):
    """(dataset, collate) of the run: long clips folded into the batch
    (``--use_clipdataset``), a VSPW frame and a ``--dataroot2`` frame an
    item (``--usetwodata``), or VSPW frames."""
    if getattr(args, "use_clipdataset", False):
        return LongClipDataset(args, "train", seed=seed), collate_clip_frames
    if getattr(args, "usetwodata", False):
        return TwoDataset(args, "train", seed=seed), collate_two_frames
    return FrameDataset(args, "train", seed=seed), collate_frames


def train(cfg, args, logger=None, max_steps: int | None = None):
    """Train the per-frame model of ``cfg.MODEL``; stops after
    ``max_steps`` steps of this run when given, or at the first step
    boundary after a SIGTERM or SIGINT, with ``preempt_<step>.pth`` saved
    in ``cfg.DIR``.  With ``args.resume`` it starts from the newest
    checkpoint there.  Returns the model (on ``args.device``, in training
    mode)."""
    refuse_unported(args)
    logger = logger or setup_logger()
    device = resolve_device(getattr(args, "device", "cuda"))
    seed = getattr(args, "seed", None)
    seed = cfg.TRAIN.seed if seed is None else seed
    model = build_segmentation(cfg, args.num_class)
    init_weights(model, torch.Generator().manual_seed(seed))
    apply_pretrained_init(model, cfg, args, logger)
    model.to(device).train()
    dropout_rng = torch.Generator(device=device).manual_seed(seed)
    set_dropout_generator(model, dropout_rng)

    dataset, collate = train_dataset(args, seed)
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

    start_epoch, skip, step = cfg.TRAIN.start_epoch, 0, 0
    if getattr(args, "resume", False):
        latest = checkpoint.newest_of(
            checkpoint.latest_checkpoint(cfg.DIR),
            checkpoint.latest_checkpoint(cfg.DIR,
                                         prefix=checkpoint.PREEMPT_PREFIX))
        if latest:
            # the run's position is the restored step, whether the save was
            # an epoch's or a preemption's (JAX train.py:92-110)
            step, _ = checkpoint.load_checkpoint(latest, model, optimizer,
                                                 scheduler, dropout_rng)
            start_epoch, skip = divmod(step, len(loader))
            logger.info(f"resumed from {latest} (epoch {start_epoch}, step "
                        f"{step}, skipping {skip} batches)")

    # batch_time: the data wait and the step, synchronised with the card
    batch_time, data_time = StepTimer(device), AverageMeter()
    ave_loss, ave_acc = AverageMeter(), AverageMeter()
    steps_run = 0
    profile_dir = getattr(args, "profile_dir", "")
    with checkpoint.PreemptionCheckpointer(cfg.DIR) as preempt, \
            contextlib.ExitStack() as tracing:
        if profile_dir:
            tracing.enter_context(trace(profile_dir, device))
        for epoch in range(start_epoch, args.totalepoch):
            # the shuffle and FrameDataset's draws are keyed by the epoch
            loader.set_epoch(epoch)
            # a resumed run makes and drops the batches its start epoch
            # consumed, as JAX's does (train.py:155-157)
            drop = skip if epoch == start_epoch else 0
            batch_time.start()
            # data_time: the wait for a batch on the card
            walk = iter(loader)
            batches = device_prefetch(walk, device, cfg.TPU.prefetch)
            # closed on every way out: the loader's worker is gone then
            with contextlib.closing(walk), contextlib.closing(batches):
                for i, batch in enumerate(batches):
                    if i < drop:
                        batch_time.start()
                        continue
                    data_time.update(batch_time.elapsed())
                    with annotate("train_step"):
                        metrics = train_step(model, optimizer, scheduler,
                                             batch, loss_fn)
                    step += 1
                    steps_run += 1
                    if profile_dir and steps_run == PROFILE_LAST_STEP + 1:
                        tracing.close()
                        logger.info(f"profiler trace written to "
                                    f"{profile_dir}")
                    if preempt.requested:
                        path = preempt.save(model, optimizer, scheduler,
                                            step, epoch, dropout_rng)
                        logger.info(f"preemption: saved {path}; exiting")
                        return model
                    loss, acc = float(metrics["loss"]), float(metrics["acc"])
                    batch_time.stop()
                    batch_time.start()
                    ave_loss.update(loss)
                    ave_acc.update(acc * 100)
                    if i % cfg.TRAIN.disp_iter == 0:
                        logger.info(
                            f"Epoch: [{epoch}][{i}/{len(loader)}], "
                            f"Time: {batch_time.mean():.2f}, "
                            f"Data: {data_time.average():.2f}, "
                            f"Loss: {ave_loss.average():.4f}, "
                            f"Acc: {ave_acc.average():.2f}")
                    if max_steps and steps_run >= max_steps:
                        break
            ckpt = checkpoint.save_checkpoint(cfg.DIR, model, optimizer,
                                              scheduler, step, epoch + 1,
                                              dropout_rng)
            logger.info(f"saved checkpoint {ckpt}")
            if max_steps and steps_run >= max_steps:
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
    # the global stream that --refrng draws from, seeded as JAX's train.py
    # seeds it
    np.random.seed(cfg.TRAIN.seed if args.seed is None else args.seed)
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

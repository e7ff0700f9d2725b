"""argparse surface of the trainers and the per-frame eval (copies of the
JAX package's config/args.py ``build_train_parser``,
``build_train_clip_parser`` and ``postprocess_args``, and of test.py's
``build_eval_parser``; reference train.py:347-398, train_clip2.py:404-489),
plus ``--device`` and ``--seed``.

Flag names and defaults are the reference's, so its shell entry points
translate 1:1.  Every flag that the JAX clip trainer reads, the port's
reads (``--pre_enc`` / ``--pre_dec``: pretrained.py).  Flags that neither
clip trainer reads (the reference's multi-GPU and per-frame flags, the
eval-only ``--use_memory`` / ``--memory_num`` that ``test_clip`` and the
trainer's validation read, and those of methods that are not ported:
``--gpus``, ``--trainfps``, ``--clip_up``, ``--othergt`` ...) stay parsed
for the reference's shell entry points.  The per-frame entry points refuse the
flags whose feature the port does not have yet (:func:`refuse_unported`),
naming the ROADMAP item that ports it: none is accepted and ignored.
"""

import argparse

TEMPORAL_METHODS = [
    "netwarp", "ETC", "nonlocal3d", "tdnet", "our_warp", "propnet",
    "our_warp_merge", "clip_psp", "clip_ocr", "netwarp_ocr", "etc_ocr",
]


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--cfg", type=str, metavar="FILE", required=True,
                        help="path to YAML config preset")
    parser.add_argument("--gpus", default="0",
                        help="kept for reference-CLI compatibility; unused")
    parser.add_argument("--predir", default="")
    parser.add_argument("--num_class", type=int, default=124)
    parser.add_argument("--batchsize", type=int, default=16)
    parser.add_argument("--workers", type=int, default=0)
    parser.add_argument("--start_gpu", type=int, default=0)
    parser.add_argument("--gpu_num", type=int, default=1)
    parser.add_argument("--dataroot", type=str, default="")
    parser.add_argument("--trainfps", type=int, default=1)
    parser.add_argument("--lr", type=float, default=0.02)
    parser.add_argument("--saveroot", type=str, default="")
    parser.add_argument("--totalepoch", type=int, default=30)
    parser.add_argument("--dataroot2", type=str, default="")
    parser.add_argument("--usetwodata", type=str2bool, default=False)
    parser.add_argument("--cropsize", type=int, default=531)
    parser.add_argument("--validation", type=str2bool, default=True)
    parser.add_argument("--lesslabel", type=str2bool, default=False)
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (raises without a card) or cpu")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed of the random init, the data order and "
                             "the dropout masks (default: TRAIN.seed)")
    parser.add_argument("opts", help="KEY VALUE config overrides",
                        default=None, nargs=argparse.REMAINDER)


def build_train_parser() -> argparse.ArgumentParser:
    """Per-frame trainer flags (reference: train.py:347-398)."""
    parser = argparse.ArgumentParser(
        description="Semantic segmentation training (PyTorch port)")
    add_common_args(parser)
    parser.add_argument("--multi_scale", type=str2bool, default=True)
    parser.add_argument("--refrng", type=str2bool, default=False,
                        help="not ported yet (raises)")
    parser.add_argument("--train_filter", type=str2bool, default=False,
                        help="crop 480x720 instead of --cropsize")
    parser.add_argument("--use_clipdataset", type=str2bool, default=False,
                        help="long clips (--clip_num, --dilation2) folded "
                             "into the batch")
    parser.add_argument("--dilation2", type=str, default="2,5,9")
    parser.add_argument("--clip_num", type=int, default=4)
    parser.add_argument("--dilation_num", type=int, default=0)
    parser.add_argument("--use_float16", type=str2bool, default=False,
                        help="not ported yet (raises)")
    parser.add_argument("--resume", type=str2bool, default=False,
                        help="not ported yet (raises)")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="not ported yet (raises)")
    return parser


def build_eval_parser() -> argparse.ArgumentParser:
    """Per-frame eval flags (the JAX package's test.py)."""
    p = argparse.ArgumentParser(
        description="Semantic segmentation eval (PyTorch port)")
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("--dataroot", type=str, default="")
    p.add_argument("--split", type=str, default="val")
    p.add_argument("--num_class", type=int, default=124)
    p.add_argument("--load", type=str, default="",
                   help="port checkpoint: torch.save of the state_dict, or "
                        "a checkpoint of train")
    p.add_argument("--torch_enc", "--load_en", dest="torch_enc", type=str,
                   default="", help="reference torch encoder .pth "
                                    "(encoder_epoch_N), loaded strict")
    p.add_argument("--torch_dec", "--load_de", dest="torch_dec", type=str,
                   default="", help="reference torch decoder .pth "
                                    "(decoder_epoch_N), loaded strict")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random init under the loaded weights")
    p.add_argument("--saveroot", type=str, default="")
    p.add_argument("--is_save", action="store_true")
    p.add_argument("--lesslabel", action="store_true")
    p.add_argument("--use_720p", action="store_true",
                   help="resize frames and masks to 1080x720")
    p.add_argument("--max_videos", type=int, default=0)
    p.add_argument("--width_bucket", type=int, default=64,
                   help="pad eval frame widths to multiples of this "
                        "(heights to the stride, 32) and run the masked "
                        "model at the true size (ops/masked.py); 0 = exact "
                        "shapes")
    p.add_argument("--serve_dtype", choices=("bf16", "int8"), default="bf16",
                   help="the JAX CLI's name of its default path; the port "
                        "computes in float32, and 'int8' is not ported yet "
                        "(raises)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (raises without a card) or cpu")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p


#: flag → (the value that means "off", the ROADMAP Queue A item porting it)
UNPORTED_FLAGS = {
    "usetwodata": (False, 7), "resume": (False, 7), "use_float16": (False, 7),
    "refrng": (False, 5), "serve_dtype": ("bf16", 9), "profile_dir": ("", 8),
}


def refuse_unported(args) -> None:
    """Raise NotImplementedError for a flag of ``UNPORTED_FLAGS`` that is
    set, naming the ROADMAP item that ports it."""
    for flag, (off, item) in UNPORTED_FLAGS.items():
        value = getattr(args, flag, off)
        if value != off:
            raise NotImplementedError(
                f"--{flag} {value} is not ported yet (ROADMAP Queue A item "
                f"{item})")


def build_train_clip_parser() -> argparse.ArgumentParser:
    """Temporal-method trainer flags (reference: train_clip2.py:404-489)."""
    parser = argparse.ArgumentParser(
        description="Video segmentation training (PyTorch port)")
    add_common_args(parser)
    parser.add_argument("--multi_scale", type=str2bool, default=False)
    parser.add_argument("--clip_num", type=int, default=5)
    parser.add_argument("--dilation_num", type=int, default=3)
    parser.add_argument("--clip_up", type=str2bool, default=False)
    parser.add_argument("--clip_middle", type=str2bool, default=False)
    parser.add_argument("--fix", type=str2bool, default=False)
    parser.add_argument("--othergt", type=str2bool, default=False)
    parser.add_argument("--propclip2", type=str2bool, default=False)
    parser.add_argument("--early_usecat", type=str2bool, default=False)
    parser.add_argument("--earlyfuse", type=str2bool, default=False)
    parser.add_argument("--allsup", type=str2bool, default=False)
    parser.add_argument("--allsup_scale", type=float, default=0.3)
    parser.add_argument("--deepsup_scale", type=float, default=0.4)
    parser.add_argument("--linear_combine", type=str2bool, default=False)
    parser.add_argument("--distsoftmax", type=str2bool, default=False)
    parser.add_argument("--distnearest", type=str2bool, default=False)
    parser.add_argument("--temp", type=float, default=3)
    parser.add_argument("--max_distances", type=str, default="10")
    parser.add_argument("--pre_enc", type=str, default="")
    parser.add_argument("--pre_dec", type=str, default="")
    parser.add_argument("--method", type=str, default="",
                        choices=TEMPORAL_METHODS)
    parser.add_argument("--dilation2", type=str, default="2,5,9")
    parser.add_argument("--resume_epoch", type=int, default=0)
    parser.add_argument("--clipocr_all", type=str2bool, default=False)
    parser.add_argument("--use_memory", type=str2bool, default=False)
    parser.add_argument("--memory_num", type=int, default=8)
    parser.add_argument("--st_weight", type=float, default=0.1)
    parser.add_argument("--psp_weight", type=str2bool, default=False)
    return parser


def postprocess_args(args) -> None:
    """Normalise list-valued string flags (reference: train_clip2.py:494-496)."""
    if hasattr(args, "max_distances") and isinstance(args.max_distances, str):
        args.max_distances = [int(d) for d in args.max_distances.split(",")]
    if hasattr(args, "dilation2") and isinstance(args.dilation2, str):
        args.dilation2 = [int(d) for d in args.dilation2.split(",")]

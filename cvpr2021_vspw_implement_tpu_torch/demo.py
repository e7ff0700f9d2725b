"""Optical-flow demo (JAX counterpart: demo.py; reference RAFT/demo.py):
RAFT in test mode over each adjacent pair of the frames in a directory
(sorted by name), each pair at its own /8-padded size (``tc_cal.pair_flow``
at exact shapes), the flow drawn in the Middlebury colours
(``models/raft/flow_viz.py``) as ``<out>/<stem>_flow.png``.  On a card a
pair above 4096 feature positions (VSPW-480p: 60x107) runs the corr lookup
(B1) once and the GRU pass (B4) twice a refinement.

    python -m cvpr2021_vspw_implement_tpu_torch.demo --path FRAMES \\
        --out flow_out --raft_ckpt raft.pth [--iters 20]

``--raft_ckpt`` takes a port checkpoint (``torch.save`` of the RAFT
``state_dict``, the reference's names); random weights need
``--allow_random_raft``, as ``tc_cal``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from .models.raft.flow_viz import flow_to_image
from .tc_cal import build_raft, pair_flow
from .utils import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description="RAFT flow demo (PyTorch port)")
    p.add_argument("--path", required=True, help="directory of frames")
    p.add_argument("--out", default="flow_out")
    p.add_argument("--raft_ckpt", default="")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--allow_random_raft", action="store_true",
                   help="a seeded random RAFT (seed 0) when --raft_ckpt is "
                        "not given")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> list[np.ndarray]:
    """Write the flow PNGs; returns the flows, [H, W, 2] float32 each."""
    args = build_parser().parse_args(argv)
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = resolve_device(args.device)
    model = build_raft(argparse.Namespace(
        raft_ckpt=args.raft_ckpt, allow_random_raft=args.allow_random_raft,
        raft_iters=args.iters, seed=0), device)

    def load(name):
        img = np.asarray(Image.open(os.path.join(args.path, name))
                         .convert("RGB"), np.float32)
        return torch.from_numpy(img).permute(2, 0, 1)[None].to(device)

    frames = sorted(f for f in os.listdir(args.path)
                    if f.lower().endswith((".png", ".jpg", ".jpeg")))
    os.makedirs(args.out, exist_ok=True)
    flows = []
    for a, b in zip(frames[:-1], frames[1:]):
        flow = pair_flow(model, load(a), load(b), 0)[0].permute(1, 2, 0)
        flows.append(flow.cpu().numpy())
        stem = os.path.splitext(a)[0]
        Image.fromarray(flow_to_image(flows[-1])).save(
            os.path.join(args.out, f"{stem}_flow.png"))
        print(f"{a} -> {b}: |flow| max {np.abs(flows[-1]).max():.2f}")
    return flows


if __name__ == "__main__":
    main()

"""How the nearest mode's picks spread over the keys at B5's training shape,
the work of its backward's gather (``kernels/csrc/local_agg_bwd.cu``'s
nearest kernel sums, for each key, the upstream gradient of every query that
picked it).

    python3 tools/torch_nearest_picks.py

On the two inputs that ``chip_smoke.py`` checks the nearest backward on
(its ``local_agg_backward_case`` at Cd 128: B = 2, 60x60, Cv 256, r = 10;
and the same with ``crowded_y_dist``, where one key takes (2r + 1)^2 = 441
picks an image), runs the nearest forward kernel with its index buffer, as
training does, and prints the card's name and power limit, then one JSON
line a case: the picks that lie outside the image (they take nothing), the
keys picked, and the most picks of one key.  Needs a CUDA device; builds
the kernels of this checkout.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_nearest_picks: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from cvpr2021_vspw_implement_tpu_torch.ops import local_agg

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    g = torch.Generator(device="cuda").manual_seed(smoke.BACKWARD_SEED)
    x, yd, yv, _ = smoke.local_agg_backward_case(torch, g, 128)
    b, _, h, w = x.shape
    r = 10
    for case, y_dist in (("smoke", yd),
                         ("crowded", smoke.crowded_y_dist(torch, yd, r))):
        _, idx = local_agg.local_nearest_aggregate_index(x, y_dist, yv, r)
        picks = smoke.nearest_picks(torch, idx, r)
        print(json.dumps({
            "case": case, "shape": f"{b}x{h}x{w}, Cd 128, Cv 256, r {r}",
            "picks": b * h * w,
            "picks_outside_image": b * h * w - int(picks.sum()),
            "keys_picked": int((picks > 0).sum()),
            "most_picks_of_a_key": int(picks.max())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

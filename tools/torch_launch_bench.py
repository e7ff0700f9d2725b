"""What a launch of the corr lookup (B1) and the band re-zero (B6) costs the
host, and the two kernels of two checkouts side by side on one card.

    python3 tools/torch_launch_bench.py [--root DIR] [--compare DIR]

Without ``--compare``, for the port's package under ``--root`` (default:
this checkout), prints one JSON line with

* ``parts_us``: the host's time a call (host clock, the median of 5 runs of
  400 calls, in us) of each step of the launch path: ``kernels.load`` (lock
  and dict lookup), ``kernels.entry`` (one dict lookup; where the checkout
  has it), ``torch.cuda.current_stream(device).cuda_stream``,
  PyTorch's raw stream getter, the ``ctypes`` call of each C entry point
  with arguments that make it return before launching (its conversions and
  the call alone), the same call that launches a small band
  (``cudaLaunchKernel`` and ``cudaGetLastError`` added), and the whole
  wrapper at that small band;
* ``shapes``: on the inputs that ``chip_smoke.py`` checks B1 and B6 on
  (its ``lookup_cases`` and ``band_cases``), the wrapper's host enqueue a
  call and its device time a launch (``kernels/timing.py`` of this
  checkout), and a digest of its result.  The smoke prints the same clocks
  with the profiler's, the plain version's and the yardsticks'; this tool
  only adds the side by side.

With ``--compare PARENT`` (an unpacked checkout of another commit), runs the
above in four processes, PARENT, this one, this one, PARENT, and prints the
enqueue and device time at each shape side by side and whether the four
results are bitwise equal, then the JSON of all four runs.  Each process
builds its own kernels into its checkout's ``build/kernels``.  Prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def from_this_checkout(name, *path):
    """Module ``name`` loaded from this checkout's file, whichever package
    ``sys.path`` resolves."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(fn, n=400, blocks=5):
    """Host time of a call in us: the median of ``blocks`` runs of ``n``."""
    for _ in range(20):
        fn()
    runs = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append(time.perf_counter() - t0)
    return 1e6 * sorted(runs)[blocks // 2] / n


def measure(root):
    sys.path.insert(0, root)
    import torch
    from cvpr2021_vspw_implement_tpu_torch import kernels
    from cvpr2021_vspw_implement_tpu_torch.ops.band_zero import band_zero
    from cvpr2021_vspw_implement_tpu_torch.ops.corr_lookup import \
        lookup_corr_pyramid

    timing = from_this_checkout("timing", "cvpr2021_vspw_implement_tpu_torch",
                                "kernels", "timing.py")
    smoke = from_this_checkout("chip_smoke", "chip_smoke.py")
    dev = torch.device("cuda")
    idx = torch.cuda.current_device()
    kernels.build(("corr_lookup", "band_zero"))
    bz = kernels.load("band_zero").band_zero_f32
    cl = kernels.load("corr_lookup").corr_lookup_f32
    small = torch.randn(1, 1, 8, 8, device=dev)
    ptr = small.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    parts = {
        "kernels.load": host_us(lambda: kernels.load("band_zero")),
        "current_stream().cuda_stream": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "raw stream getter": host_us(
            lambda: torch._C._cuda_getCurrentRawStream(idx)),
        "ctypes, band_zero_f32 without launch (7 args)": host_us(
            lambda: bz(ptr, 1, 8, 8, 8, 8, stream)),
        "ctypes, corr_lookup_f32 without launch (18 args)": host_us(
            lambda: cl(ptr, ptr, ptr, ptr, 8, 8, 8, 8, 8, 8, 8, 8, 0, ptr,
                       ptr, 1, 1, stream)),
        "ctypes, band_zero_f32 with a launch": host_us(
            lambda: bz(ptr, 1, 8, 8, 8, 7, stream)),
        "band_zero wrapper with a launch": host_us(
            lambda: band_zero(small, 8, 7)),
    }
    if hasattr(kernels, "entry"):       # the wrappers' lookup, where it exists
        parts["kernels.entry"] = host_us(
            lambda: kernels.entry("band_zero_f32"))
    torch.cuda.synchronize()

    calls = {}
    for shape, pyr, coords in smoke.lookup_cases(torch):
        calls[f"corr_lookup {shape}"] = (
            lambda pyr=pyr, coords=coords: lookup_corr_pyramid(pyr, coords),
            lookup_corr_pyramid)
    for label, x, hv, wv in smoke.band_cases(torch):
        calls[f"band_zero {label}"] = (
            lambda x=x, hv=hv, wv=wv: band_zero(x, hv, wv), band_zero)
    shapes = {}
    for name, (fn, wrapper) in calls.items():
        out = fn()
        shapes[name] = {
            # the result's bytes: equal digests are bitwise equal results
            "digest": hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest(),
            "enqueue_ms": timing.enqueue_ms(fn, counted=(wrapper,)),
            "device_ms": timing.device_ms(fn, counted=(wrapper,)),
        }
    return {"root": os.path.abspath(root), "parts_us": parts,
            "shapes": shapes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--compare", default=None)
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_launch_bench: CUDA is not available", file=sys.stderr)
        return 1
    if not opts.compare:
        print(json.dumps(measure(opts.root)))
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    runs = []
    for root in (opts.compare, REPO, REPO, opts.compare):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--root", root], capture_output=True, text=True)
        if out.returncode:
            print(out.stdout + out.stderr)
            return out.returncode
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    names = ("before 1", "after 1", "after 2", "before 2")
    print("host enqueue / device (graph replay), ms a call; order: "
          + ", ".join(names))
    for shape in runs[0]["shapes"]:
        cells = [f"{r['enqueue_ms']:.5f}/{r['device_ms']:.5f}"
                 for r in (run["shapes"][shape] for run in runs)]
        same = len({run["shapes"][shape]["digest"] for run in runs}) == 1
        print(f"{shape}: " + "  ".join(cells) + "; results "
              + ("bitwise equal in all four" if same else "DIFFER"))
    for name, run in zip(names, runs):
        print(f"launch-path parts, {name}, us a call: " + "; ".join(
            f"{k} {round(v, 3)}" for k, v in run["parts_us"].items()))
    print(json.dumps({"runs": dict(zip(names, runs))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's bench entry point (``cvpr2021_vspw_implement_tpu_torch.bench``)
on the CPU, and the operation counts of the hand-written kernels that its
``mfu`` rows and chip_smoke.py's bounds read (``ops/*.py``).

* The bench at its toy configuration (ResNet-18-dilated, 64x96 frames, 5
  classes) with ``--quick`` prints one JSON line with every row (the keys
  chip_smoke.py checks on the card), positive and finite times and rates,
  and null ``mfu`` fields on the CPU.
* It refuses the CPU unless asked for it, a card without an f32 peak in
  its table, and a row that fails.
* Each kernel's count against ``FlopCounterMode`` over the kernel's plain
  version at a small shape.  B2-B4's plain versions are ``F.conv2d``, which
  the counter counts: equal.  B1's and B5's are elementwise, which it
  counts here through a mapping of the elementwise ops (one operation an
  output element, one a summed element): B1's count is the plain version's
  arithmetic, equal; B5's counts the window products, and the plain
  version's other arithmetic (the norms, the distances' assembly, the
  weights) is under 2% of it at the path's r = 10, Cd 128, Cv 256.
"""

import json
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke
from cvpr2021_vspw_implement_tpu_torch import bench
from cvpr2021_vspw_implement_tpu_torch.models.raft.corr import \
    build_corr_pyramid
from cvpr2021_vspw_implement_tpu_torch.ops import local_agg
from cvpr2021_vspw_implement_tpu_torch.ops.corr_lookup import (
    lookup_corr_pyramid_flops, lookup_corr_pyramid_plain)
from cvpr2021_vspw_implement_tpu_torch.ops.gru_flowhead import (
    gru_flowhead_flops, gru_flowhead_plain)
from cvpr2021_vspw_implement_tpu_torch.ops.motion_encoder import (
    motion_encoder_flops, motion_encoder_plain)
from cvpr2021_vspw_implement_tpu_torch.ops.sep_gru import (
    sep_conv_gru_pass_flops, sep_conv_gru_pass_plain)
import torch_port_util  # noqa: F401  (caps torch's threads in a worker)

TOY = ["--device", "cpu", "--toy", "--quick"]


@pytest.fixture(scope="module")
def toy_run():
    """(the printed lines, the returned dict) of one toy run."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = bench.main(TOY)
    return buf.getvalue().splitlines(), out


def test_bench_prints_one_json_line_with_every_row(toy_run):
    lines, out = toy_run
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert printed == json.loads(json.dumps(out))
    assert set(chip_smoke.BENCH_KEYS) <= set(printed)
    for key in chip_smoke.BENCH_TIMES:
        assert math.isfinite(printed[key]) and printed[key] > 0, key
    assert math.isfinite(printed["stream_bucketed_overhead_pct"])
    for key in chip_smoke.BENCH_MFUS:
        assert printed[key] is None, key
    assert printed["train_peak_mem_gib"] is None
    assert printed["peak_tflops_f32"] is None
    assert printed["power_limit_w"] is None
    assert printed["device"] == "cpu" and printed["dtype"] == "float32"
    assert all(math.isfinite(v) and v >= 0
               for v in printed["spreads_pct"].values())
    assert "int8_stream_frames_per_sec" in printed["not_ported"]
    assert not any(k.startswith(("tdnet_", "nonlocal3d_"))
                   for k in printed["not_ported"])
    assert printed["counts"] == bench.COUNTS["quick"]
    # on the CPU the wrappers take their plain versions: no launch
    assert not any(n for row in printed["launches"].values()
                   for n in row.values())


def test_bench_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--toy", "--quick"])


def test_bench_refuses_a_card_without_a_peak(monkeypatch):
    class Smi:
        stdout = "NVIDIA A100-SXM4-80GB, 400.00 W\n"

    monkeypatch.setattr(bench.subprocess, "run", lambda *a, **k: Smi)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda index=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(RuntimeError, match="no f32 peak"):
        bench.card(torch.device("cuda", 0))
    Smi.stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda index=None: "NVIDIA H100 80GB HBM3")
    assert bench.card(torch.device("cuda", 0)) == (
        "NVIDIA H100 80GB HBM3", 700.0, 67e12)


def test_bench_fails_on_a_failed_row(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("a broken row")

    monkeypatch.setattr(bench, "inference_pred", broken)
    with pytest.raises(RuntimeError, match="a broken row"):
        bench.main(TOY)


# the operation counts of the kernels, against FlopCounterMode

def _elementwise(*args, out_val=None, **kwargs):
    return out_val.numel() if out_val.is_floating_point() else 0


def _summed(x, *args, out_val=None, **kwargs):
    return x.numel() if x.is_floating_point() else 0


_elementwise._get_raw = _summed._get_raw = True
aten = torch.ops.aten
ELEMENTWISE = {**{op: _elementwise for op in (
    aten.add, aten.add_, aten.sub, aten.rsub, aten.mul, aten.div,
    aten.pow)}, aten.sum: _summed}


def _counted(fn, *args, elementwise=False, **kwargs):
    with FlopCounterMode(display=False, custom_mapping=ELEMENTWISE
                         if elementwise else None) as fc:
        fn(*args, **kwargs)
    return fc.get_total_flops()


def _rand(g, *shape, scale=1.0):
    return scale * torch.randn(*shape, generator=g)


def test_corr_lookup_flops_match_the_plain_version():
    g = torch.Generator().manual_seed(0)
    b, h, w = 2, 16, 12
    pyramid = build_corr_pyramid(_rand(g, b, 32, h, w), _rand(g, b, 32, h, w))
    coords = 16 * torch.rand(b, 2, h, w, generator=g)
    for levels in (4, 1):
        assert lookup_corr_pyramid_flops(b, h, w, levels) == _counted(
            lookup_corr_pyramid_plain, pyramid[:levels], coords,
            elementwise=True)


@pytest.mark.parametrize("mode", ["sigmoid", "softmax", "nearest"])
def test_local_aggregate_flops_match_the_plain_version(mode):
    g = torch.Generator().manual_seed(1)
    b, cd, cv, h, w, r = 1, 128, 256, 6, 7, 10
    x, yd = _rand(g, b, cd, h, w), _rand(g, b, cd, h, w)
    yv = _rand(g, b, cv, h, w)
    want = local_agg.local_aggregate_flops(mode, b, h, w, cd, cv, r)
    got = _counted(getattr(local_agg, f"local_{mode}_aggregate_plain"), x,
                   yd, yv, r, elementwise=True)
    assert want <= got <= 1.02 * want


def test_tensor_core_kernel_flops_match_their_plain_versions():
    g = torch.Generator().manual_seed(2)
    b, h, w, hd, cx, cf, ck = 2, 5, 6, 32, 64, 96, 324
    h0 = torch.tanh(_rand(g, b, hd, h, w))
    x = _rand(g, b, cx, h, w)

    def wb(taps, cin, cout):
        return _rand(g, taps, cin, cout, scale=0.03), _rand(g, cout)

    gru = (*wb(5, hd + cx, 2 * hd), *wb(5, hd + cx, hd))
    assert sep_conv_gru_pass_flops(b, h, w, hd, cx) == _counted(
        sep_conv_gru_pass_plain, h0, x, *gru, 0)
    gw = {"zr1": wb(5, hd + cx, 2 * hd), "q1": wb(5, hd + cx, hd),
          "zr2": wb(5, hd + cx, 2 * hd), "q2": wb(5, hd + cx, hd),
          "fh_conv1": wb(9, hd, cf), "fh_conv2": wb(9, cf, 2)}
    assert gru_flowhead_flops(b, h, w, hd, cx, cf) == _counted(
        gru_flowhead_plain, h0, x, gw)
    mw = {"convc1": wb(1, ck, 256), "convc2": wb(9, 256, 192),
          "convf1": wb(49, 2, 128), "convf2": wb(9, 128, 64),
          "conv": wb(9, 256, 126)}
    assert motion_encoder_flops(b, h, w, ck) == _counted(
        motion_encoder_plain, _rand(g, b, ck, h, w), _rand(g, b, 2, h, w),
        mw)


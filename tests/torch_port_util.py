"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Both sides get the same numpy inputs; JAX arrays are NHWC and port tensors
NCHW.  Flax variables are given non-trivial BatchNorm statistics so the
weight carry-over is exercised beyond the identity init.
"""

from __future__ import annotations

import numpy as np
import torch

# the suite runs as several pytest workers sharing the host's cores; the
# port's CPU tests keep torch from claiming all of them in each worker
torch.set_num_threads(2)


def to_nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a, np.float32), -1, -3)))


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().cpu().numpy(), -3, -1)


def numpy_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.array(tree, np.float32)


def flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def perturb_batchnorm(variables, seed: int):
    """numpy copy of a Flax {"params", "batch_stats"} tree whose BN nodes
    carry random scale, bias, mean and var."""
    rng = np.random.default_rng(seed)
    v = numpy_tree(variables)
    params, stats = v["params"], v.get("batch_stats", {})
    for path in sorted({k[:-1] for k in flatten(stats)}):
        node_s = stats
        node_p = params
        for p in path:
            node_s = node_s[p]
            node_p = node_p[p]
        n = node_s["mean"].shape[0]
        node_s["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
        node_s["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        node_p["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        node_p["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
    return v


def assert_trees_equal(got, want):
    fg, fw = flatten(got), flatten(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        np.testing.assert_array_equal(fg[k], fw[k], err_msg="/".join(k))


def pyramid(rng, b, h, w):
    """A 4-level pyramid as the port builds it (2x2 floor pooling)."""
    corr = rng.normal(size=(b, h * w, h, w)).astype(np.float32)
    levels = [corr]
    for _ in range(3):
        bb, p, hh, ww = levels[-1].shape
        h2, w2 = hh // 2, ww // 2
        levels.append(levels[-1][:, :, :h2 * 2, :w2 * 2]
                      .reshape(bb, p, h2, 2, w2, 2).mean(axis=(3, 5)))
    return levels


def query_coords(rng, b, h, w):
    """Non-integer coords reaching well outside the level-0 plane."""
    x = rng.uniform(-6.0, w + 6.0, size=(b, h, w))
    y = rng.uniform(-6.0, h + 6.0, size=(b, h, w))
    c = np.stack([x, y], -1).astype(np.float32)          # [B, H, W, 2]
    c[0, 0, 0] = (3.0, 2.0)                              # integer taps
    return c


def gru_inputs(rng, b, h, w, hd, cx, axis):
    cin = hd + cx
    kshape = (1, 5) if axis == 0 else (5, 1)
    hh = np.tanh(rng.normal(size=(b, h, w, hd))).astype(np.float32)
    x = rng.normal(size=(b, h, w, cx)).astype(np.float32)
    kzr = (0.1 * rng.normal(size=kshape + (cin, 2 * hd))).astype(np.float32)
    bzr = (0.1 * rng.normal(size=(2 * hd,))).astype(np.float32)
    kq = (0.1 * rng.normal(size=kshape + (cin, hd))).astype(np.float32)
    bq = (0.1 * rng.normal(size=(hd,))).astype(np.float32)
    return hh, x, kzr, bzr, kq, bq


def port_gru_args(hh, x, kzr, bzr, kq, bq):
    """NHWC/HWIO numpy → the port's NCHW tensors and [5, cin, cout] taps."""
    def nchw(a):
        return torch.from_numpy(np.moveaxis(a, -1, 1).copy())

    def taps(k):
        return torch.from_numpy(k.reshape(5, *k.shape[2:]).copy())

    return (nchw(hh), nchw(x), taps(kzr), torch.from_numpy(bzr), taps(kq),
            torch.from_numpy(bq))


_MOTION_KERNELS = {"convc1": (1, 1, 324, 256), "convc2": (3, 3, 256, 192),
                   "convf1": (7, 7, 2, 128), "convf2": (3, 3, 128, 64),
                   "conv": (3, 3, 256, 126)}


def _conv_params(rng, shapes, scale):
    return {name: {"kernel": (scale * rng.normal(size=s)).astype(np.float32),
                   "bias": (0.1 * rng.normal(size=s[-1:])).astype(np.float32)}
            for name, s in shapes.items()}


def motion_inputs(rng, b, h, w, scale=0.05, ck=324):
    """NHWC corr and flow and the HWIO parameter dict of the JAX motion
    encoder (``motion_encoder_xla`` / ``motion_encoder_fused``); ``ck``
    correlation channels (RAFT's 4 levels of 9x9: 324)."""
    corr = rng.normal(size=(b, h, w, ck)).astype(np.float32)
    flow = rng.normal(0, 2, size=(b, h, w, 2)).astype(np.float32)
    shapes = {**_MOTION_KERNELS, "convc1": (1, 1, ck, 256)}
    return corr, flow, _conv_params(rng, shapes, scale)


def gru_flowhead_inputs(rng, b, h, w, hd=128, cx=256, scale=0.05):
    """NHWC net and x and the HWIO parameter dict of the JAX GRU + flow head
    (``gru_flowhead_xla`` / ``gru_flowhead_fused``)."""
    cin = hd + cx
    shapes = {}
    for i, k in ((1, (1, 5)), (2, (5, 1))):
        for g in "zrq":
            shapes[f"conv{g}{i}"] = k + (cin, hd)
    shapes["fh_conv1"] = (3, 3, hd, 256)
    shapes["fh_conv2"] = (3, 3, 256, 2)
    net = np.tanh(rng.normal(size=(b, h, w, hd))).astype(np.float32)
    x = rng.normal(size=(b, h, w, cx)).astype(np.float32)
    return net, x, _conv_params(rng, shapes, scale)


def _port_taps(p, names):
    """HWIO kernels of several convs over one input → the port's
    ([taps, cin, sum(cout)], bias) pair."""
    k = np.concatenate([p[n]["kernel"] for n in names], -1)
    return (torch.from_numpy(k.reshape(-1, *k.shape[2:]).copy()),
            torch.from_numpy(np.concatenate([p[n]["bias"] for n in names])))


def port_motion_weights(p):
    return {name: _port_taps(p, [name]) for name in _MOTION_KERNELS}


def port_gru_flowhead_weights(p):
    out = {name: _port_taps(p, [name]) for name in ("fh_conv1", "fh_conv2")}
    for i in (1, 2):
        out[f"zr{i}"] = _port_taps(p, [f"convz{i}", f"convr{i}"])
        out[f"q{i}"] = _port_taps(p, [f"convq{i}"])
    return out


def weights_to(weights, device):
    return {k: (w.to(device), b.to(device)) for k, (w, b) in weights.items()}


def local_agg_inputs(rng, b, h, w, cd, cv, scale=0.05, shift=(1, -1)):
    """NHWC (x, y_dist, y_val) for the local aggregations, with window
    weights far from uniform: y_dist is x shifted by ``shift`` pixels
    (wrapping) plus noise whose squared norm at each pixel lies in
    [0.01, 0.1].  So each window that holds the match has one distance there
    (a softmax score of 3.3 to 33 at temp 3, a sigmoid weight near 1), well
    away from the score's pole, against about 2 cd scale^2 elsewhere."""
    x = scale * rng.standard_normal((b, h, w, cd))
    sq = 10.0 ** (rng.random((b, h, w, 1)) - 2.0)
    yd = np.roll(x, shift, (1, 2)) + np.sqrt(sq / cd) * rng.standard_normal(
        (b, h, w, cd))
    yv = rng.standard_normal((b, h, w, cv))
    return tuple(a.astype(np.float32) for a in (x, yd, yv))


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 → TF32 as ``cvt.rna.tf32.f32`` does it: round to nearest, ties
    away from zero, keeping 10 explicit mantissa bits (finite inputs)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_products(conv, inp, w, passes: int):
    """``conv(inp, w)`` with TF32 operands: one product hi*hi (``passes`` 1)
    or the 3xTF32 sum lo*hi + hi*lo + hi*hi (``passes`` 3), with hi =
    tf32(v) and lo = tf32(v - hi) as the tensor-core kernels split each
    operand (kernels/csrc/mma_tf32.cuh); each product is of TF32 values
    (exact in f32), accumulated in f32 by ``conv``."""
    ih, wh = tf32_round(inp), tf32_round(w)
    if passes == 1:
        return conv(ih, wh)
    il, wl = tf32_round(inp - ih), tf32_round(w - wh)
    return conv(il, wh) + conv(ih, wl) + conv(ih, wh)


@torch.no_grad()
def perturb_port_batchnorm(model: torch.nn.Module, seed: int):
    """Give every BatchNorm of a port model random scale, bias, mean and
    var (the port-side counterpart of :func:`perturb_batchnorm`); returns
    the model."""
    rng = np.random.default_rng(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            n = m.num_features
            for t, v in ((m.running_mean, rng.normal(0, 0.1, n)),
                         (m.running_var, rng.uniform(0.5, 1.5, n)),
                         (m.weight, rng.uniform(0.5, 1.5, n)),
                         (m.bias, rng.normal(0, 0.1, n))):
                t.copy_(torch.from_numpy(v.astype(np.float32)))
    return model


@torch.no_grad()
def calibrate_batchnorm(model: torch.nn.Module, *inputs,
                        var_floor: float = 0.5):
    """``chip_smoke.calibrate_batchnorm`` (the running statistics those of
    one training-mode forward of ``inputs``), the variances then floored
    at ``var_floor``; returns the model in eval mode.  A deep seeded net
    (HRNet's hundreds of convs and residual sums) then keeps its
    activations near unit scale (with the init's identity statistics its
    logits reach ~1e9), and the floor keeps a channel that is near constant
    on these inputs from amplifying f32 rounding 300-fold."""
    import chip_smoke

    chip_smoke.calibrate_batchnorm(torch, model, *inputs)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_var.clamp_(min=var_floor)
    return model

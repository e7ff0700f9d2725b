"""The backward of B5 (the local window aggregation) on the CPU: the plain
backward of each mode against two references.

* ``torch.autograd`` of the port's plain forward;
* ``jax.grad`` of the JAX package's XLA formulation, ``warp_one_scale``
  over ``local_pairwise_dist`` (models/warp_our.py), which is what the JAX
  package trains through (its Pallas kernels define no VJP).

Inputs: ``local_agg_inputs`` near-match embeddings (B 2, a 9x11 grid, Cd
16, Cv 24), an upstream gradient N(0, 1), r in {0, 2, 3, 5} (at r = 5 the
window, 11 rows, is larger than the image).  On these inputs the sigmoid
does not saturate and the softmax stays far from its pole, so every
gradient is non-trivial; on iid N(0, 1) embeddings the sigmoid saturates
and every gradient would be 0.  Bar: within 1e-5 of the largest gradient
(f32 sums in other orders).  Nearest: x and y_dist get no gradient and
y_val's is the upstream gradient gathered to the picked keys, the same
picks on both sides (no near-tie in these inputs, which the test checks);
at r = 5 every window reaches outside the image, where the argmax quirk
picks, so every gradient is 0 on all three sides.  Softmax at r = 0 weighs
its one window position by 1 whatever the distance: x and y_dist get 0.

Also: the public functions on CPU tensors that require grad run the
explicit backward (``local_*_aggregate_backward_plain``), not autograd of
the plain forward; a valid size with grad raises; the backward's operation
count against ``FlopCounterMode`` over the plain backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke
from cvpr2021_vspw_implement_tpu.models.warp_our import \
    warp_one_scale as jax_warp_one_scale
from cvpr2021_vspw_implement_tpu.ops import local_pairwise as jlp
from cvpr2021_vspw_implement_tpu_torch.ops import local_agg
from torch_port_util import local_agg_inputs, to_nchw, to_nhwc

MODES = ("sigmoid", "softmax", "nearest")
RADII = (0, 2, 3, 5)
B, H, W, CD, CV = 2, 9, 11, 16, 24
TEMP = 3.0


def _inputs(r):
    rng = np.random.default_rng(40 + r)
    x, yd, yv = local_agg_inputs(rng, B, H, W, CD, CV)
    g = rng.standard_normal((B, H, W, CV)).astype(np.float32)
    return x, yd, yv, g


def _jax_grads(mode, x, yd, yv, g, r):
    def f(x, yd, yv):
        dist = jlp.local_pairwise_dist(x, yd, r)
        out = jax_warp_one_scale(dist, yv, r, distsoftmax=mode == "softmax",
                                 distnearest=mode == "nearest", temp=TEMP,
                                 emb_dim=CV)
        return jnp.sum(out * g)
    with jax.default_matmul_precision("highest"):
        grads = jax.grad(f, argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (x, yd, yv)))
    return [np.asarray(a) for a in grads]


def _port(fn, mode, x, yd, yv, g, r):
    """(out, the three gradients NHWC, zeros where None) of ``fn``."""
    ts = [to_nchw(a).requires_grad_() for a in (x, yd, yv)]
    kw = {"temp": TEMP} if mode == "softmax" else {}
    out = fn(*ts, r, **kw)
    (out * to_nchw(g)).sum().backward()
    return out, [to_nhwc(t.grad) if t.grad is not None else np.zeros_like(a)
                 for t, a in zip(ts, (x, yd, yv))]


@pytest.mark.parametrize("r", RADII)
@pytest.mark.parametrize("mode", MODES)
def test_plain_backward_matches_autograd_and_jax(mode, r):
    x, yd, yv, g = _inputs(r)
    out, got = _port(getattr(local_agg, f"local_{mode}_aggregate"), mode,
                     x, yd, yv, g, r)
    # the explicit backward ran, not autograd of the plain forward
    assert type(out.grad_fn).__name__.startswith(f"_{mode.capitalize()}")
    _, auto = _port(getattr(local_agg, f"local_{mode}_aggregate_plain"),
                    mode, x, yd, yv, g, r)
    jax_g = _jax_grads(mode, x, yd, yv, g, r)
    if mode == "nearest":
        dist = np.asarray(jlp.local_pairwise_dist(jnp.asarray(x),
                                                  jnp.asarray(yd), r))
        top = np.sort(dist.reshape(B, H, W, -1), -1)
        gap = top[..., -1] - top[..., -2] if top.shape[-1] > 1 else np.inf
        assert not ((top[..., -1] < 1e19)
                    & (gap <= 1e-4 * np.abs(top[..., -1]))).any()
    trivial = mode == "nearest" and 2 * r + 1 > min(H, W)
    for name, mine, a, j in zip(("x", "y_dist", "y_val"), got, auto, jax_g):
        scale = np.abs(j).max()
        if (name != "y_val" and (mode == "nearest"
                                 or mode == "softmax" and r == 0)
                or trivial):
            assert scale == 0 and not mine.any() and not a.any(), name
            continue
        assert scale > 1e-2, (name, scale)      # a gradient, not noise
        for ref in (a, j):
            err = np.abs(mine - ref).max()
            assert err <= 1e-5 * scale, (name, err, scale)


@pytest.mark.parametrize("mode", MODES)
def test_valid_size_with_grad_is_refused(mode):
    x, yd, yv, _ = _inputs(2)
    ts = [to_nchw(a).requires_grad_() for a in (x, yd, yv)]
    fn = getattr(local_agg, f"local_{mode}_aggregate")
    with pytest.raises(ValueError, match="eval only"):
        fn(*ts, 2, valid_hw=(8, 10))
    with torch.no_grad():               # no graph: eval, as before
        assert fn(*ts, 2, valid_hw=(8, 10)).shape == (B, CV, H, W)


def _elementwise(*args, out_val=None, **kwargs):
    return out_val.numel() if out_val.is_floating_point() else 0


def _summed(x, *args, out_val=None, **kwargs):
    return x.numel() if x.is_floating_point() else 0


_elementwise._get_raw = _summed._get_raw = True
_aten = torch.ops.aten
_MAPPING = {**{op: _elementwise for op in (
    _aten.add, _aten.add_, _aten.sub, _aten.rsub, _aten.mul, _aten.div)},
    _aten.sum: _summed}


@pytest.mark.parametrize("mode", ["sigmoid", "softmax"])
def test_backward_flops_match_the_plain_version(mode):
    """The smooth backward's count is its window products; the plain
    version's other arithmetic (the norms, the weights, the distances'
    assembly) is under 2% of it at the path's r = 10, Cd 128, Cv 256."""
    g = torch.Generator().manual_seed(3)
    b, cd, cv, h, w, r = 1, 128, 256, 6, 7, 10
    args = [torch.randn(b, c, h, w, generator=g) for c in (cd, cd, cv, cv)]
    want = local_agg.local_aggregate_backward_flops(mode, b, h, w, cd, cv, r)
    with FlopCounterMode(display=False, custom_mapping=_MAPPING) as fc:
        getattr(local_agg, f"local_{mode}_aggregate_backward_plain")(*args, r)
    assert want <= fc.get_total_flops() <= 1.02 * want
    assert local_agg.local_aggregate_backward_flops(
        "nearest", b, h, w, cd, cv, r) == b * h * w * cv


def test_backward_wrappers_take_the_plain_version_on_the_cpu():
    x, yd, yv, g = (to_nchw(a) for a in _inputs(2))
    for mode in ("sigmoid", "softmax"):
        fn = getattr(local_agg, f"local_{mode}_aggregate_backward")
        before = fn.launches
        got = fn(x, yd, yv, g, 2)
        want = getattr(local_agg, f"local_{mode}_aggregate_backward_plain")(
            x, yd, yv, g, 2)
        assert fn.launches == before
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    idx = local_agg.local_nearest_index_plain(x, yd, 2)
    fn = local_agg.local_nearest_aggregate_backward
    before = fn.launches
    assert torch.equal(fn(idx, g, 2),
                       local_agg.local_nearest_aggregate_backward_plain(
                           idx, g, 2))
    assert fn.launches == before
    with pytest.raises(RuntimeError, match="for device meta"):
        local_agg.local_sigmoid_aggregate_backward(
            *(t.to("meta") for t in (x, yd, yv, g)), 2)


def test_nearest_backward_at_a_crowded_key():
    """y_dist scaled by 100 at the keys whose row and column are both r mod
    2r + 1: every window inside the image holds one of them and picks it,
    so the key at (10, 10) takes all (2r + 1)^2 = 49 picks (the crowded
    case of the card's nearest backward).  The plain backward, through the
    explicit backward of the public function, against autograd of the
    plain forward and ``jax.grad`` of ``warp_one_scale``'s nearest branch."""
    b, h, w, cd, cv, r = 1, 24, 24, 8, 16, 3
    k = 2 * r + 1
    rng = np.random.default_rng(47)
    x, yd, yv = local_agg_inputs(rng, b, h, w, cd, cv)
    on = (np.arange(h)[:, None] % k == r) & (np.arange(w) % k == r)
    yd = np.where(on[None, :, :, None], 100.0 * yd, yd).astype(np.float32)
    g = rng.standard_normal((b, h, w, cv)).astype(np.float32)
    idx = local_agg.local_nearest_index_plain(to_nchw(x), to_nchw(yd), r)
    picks = chip_smoke.nearest_picks(torch, idx, r)[0]
    assert picks.max() == k * k == picks[10 * w + 10]
    out, got = _port(local_agg.local_nearest_aggregate, "nearest", x, yd, yv,
                     g, r)
    assert type(out.grad_fn).__name__.startswith("_Nearest")
    _, auto = _port(local_agg.local_nearest_aggregate_plain, "nearest", x, yd,
                    yv, g, r)
    jax_g = _jax_grads("nearest", x, yd, yv, g, r)
    scale = np.abs(jax_g[2]).max()
    assert scale > 1.0
    for ref in (auto[2], jax_g[2]):
        assert np.abs(got[2] - ref).max() <= 1e-5 * scale
    for name, mine, a, j in zip(("x", "y_dist"), got, auto, jax_g):
        assert not mine.any() and not a.any() and not j.any(), name

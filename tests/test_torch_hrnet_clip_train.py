"""HRNetV2-clip's training mode (``hrnetv2_clip``: models/hrnet_clip.py)
against the JAX package, in float64 on both sides, on the CPU: the weights
and the window of tests/test_torch_hrnet_clip.py (its ``weights``
fixture), a batch of 4.  Apart from that file because JAX's float64 train
step of W48 takes 30-100 s to build and run on the CPU.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cvpr2021_vspw_implement_tpu.methods import build_method as jax_build
from cvpr2021_vspw_implement_tpu_torch import methods
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.models import hrnet_clip
from test_torch_hrnet_clip import (K, T, VALID, _args, _jax_cfg, _nchw,
                                   _pcfg, _window, weights)  # noqa: F401
from test_torch_train_propnet_f64 import _f64, _jax_float64


def test_hrnet_clip_train_step_matches_jax(weights):
    """Training mode (C1 has no dropout), in float64 on both sides: the
    loss, every gradient and the running statistics after the step against
    ``jax.value_and_grad`` of JAX's ``seg_clip_loss`` through
    ``apply(train=True, mutable)``.  The clip frames pass the stem on its
    running statistics with no gradient, before the target's batch
    statistics update them (JAX stop_gradient and ``train=False`` for
    them): a gradient from them into the stem, or a statistic moved by
    them, would part the two.  Float64, because this step is ill
    conditioned in float32: HRNet's 2x2 maps at stride 32 batch-normalise
    16 values a channel, and the port's float32 gradients sit up to 2.7% of
    their largest element from its float64 run (JAX's, with its one-pass
    batch variance, 25%); in float64 the two sides agree within 8e-6."""
    jmodel, variables, port, _ = weights
    win = _window(2, n=4)
    lab = np.random.default_rng(6).integers(0, K, (T, 4, *VALID)).astype(
        np.int32)
    lab[-1, :, :2, :5] = 255
    v64 = _f64(variables)
    with _jax_float64():
        _, jloss = jax_build("hrnetv2_clip", _jax_cfg(), _args(), None)

        def loss_fn(params):
            outs, mut = jmodel.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                jnp.asarray(win[-1], jnp.float64),
                jnp.asarray(win[:-1], jnp.float64), train=True,
                mutable=["batch_stats"])
            return jloss(outs, {"labels": jnp.asarray(lab)})[0], mut

        (jl, mut), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"])
        jl, jg, mut = jax.tree_util.tree_map(np.asarray, (jl, jg, mut))
    model = copy.deepcopy(port).double().train()
    _, loss = methods.build_method("hrnetv2_clip", _pcfg(), _args())
    pl, acc = loss(model(_nchw(win).double()),
                   {"labels": torch.from_numpy(lab).long()})
    pl.backward()
    assert loss is hrnet_clip.seg_clip_loss and 0 <= float(acc) <= 1
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-6)
    want = load_jax_variables(copy.deepcopy(port).double(), {
        "params": jg, "batch_stats": v64["batch_stats"]})
    grads = {n: p.grad for n, p in model.named_parameters()}
    worst = 0.0
    for n, w in want.named_parameters():
        w = w.detach()
        gap = float((grads[n] - w).abs().max() / w.abs().max())
        worst = max(worst, gap)
        assert gap <= 1e-4, f"{n}: {gap:.2e} of the largest element"
    stats = load_jax_variables(copy.deepcopy(port).double(), {
        "params": v64["params"], "batch_stats": mut["batch_stats"]})
    buffers = dict(model.named_buffers())
    worst_stat = 0.0
    for n, b in stats.named_buffers():
        if not n.endswith("num_batches_tracked"):
            gap = float((buffers[n] - b).abs().max() / b.abs().max())
            worst_stat = max(worst_stat, gap)
            assert gap <= 1e-6, f"{n}: {gap:.2e} of the largest element"
    # the stem's statistics moved, by the target alone
    assert not torch.equal(model.encoder.bn1.running_mean,
                           port.encoder.bn1.running_mean.double())
    print(f"\nhrnetv2_clip train step, float64: loss {pl.item():.9f} (JAX "
          f"{float(jl):.9f}); gradients at most {worst:.2e} and running "
          f"statistics {worst_stat:.2e} of their largest element from "
          "JAX's")

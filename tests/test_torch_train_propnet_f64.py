"""PropNet's training curve in the port against the JAX trainer over four
steps in float64, and how far each side's float32 curve lies from it.

PropNet propagates hard labels, an argmax of its per-frame head, so a
float32 curve leaves the exact one once a label flips: on this curve (the
``propnet`` case of tests/test_torch_train_warp.py: ResNet-18-dilated, 5
classes, 4 frames of 48x48, batch 4, r = 2, LR 0.005, the same seeded init
and batches) both float32 curves, the port's and JAX's, part from their
float64 curves by more than the curve bar at the third or fourth step.
The f32 test holds the first two steps; this one holds all four where
rounding cannot flip a label:

* the port's float64 run (``model.double()``; the plain B5 and PropNet
  paths keep float64) against the JAX trainer's float64 run (under
  ``jax.enable_x64``, with ``jnp.float32`` read as float64 for the run, as
  the JAX package casts to float32 by name): within the curve bar, rtol
  1e-2 on the loss and atol 1e-2 on the accuracy, and within 1e-5 relative
  on the loss, since float64 leaves no room for more;
* the first two steps of the port's float32 curve against its float64
  curve at the same bar.

It prints, step by step, the relative gap of each float32 curve from its
float64 curve: the measurement behind the two-step hold.  XLA's float64
convolutions on the CPU make this file slow (about 4 minutes alone).
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cvpr2021_vspw_implement_tpu.methods import build_method as jax_build
from cvpr2021_vspw_implement_tpu_torch.methods import build_method
from cvpr2021_vspw_implement_tpu_torch.models import layers
from test_torch_train_warp import (IMPORTERS, _args, _batches, _cfgs,
                                   _jax_curve, _port_curve, _report,
                                   no_dropout)


@contextlib.contextmanager
def _jax_float64():
    """64-bit JAX, with ``jnp.float32`` read as float64 while open."""
    f32 = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        try:
            yield
        finally:
            jnp.float32 = f32


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, tree)


def _gaps(got, want):
    return np.abs(got[:, 0] - want[:, 0]) / np.abs(want[:, 0])


def test_propnet_curve_matches_jax_float64(no_dropout):  # noqa: F811
    cfg, pcfg = _cfgs()
    args = _args(method="propnet")
    jmodel, jax_loss = jax_build("propnet", cfg, args)
    port, port_loss = build_method("propnet", pcfg, args)
    layers.init_weights(port, torch.Generator().manual_seed(1))
    variables = jax.tree_util.tree_map(
        np.array, IMPORTERS["propnet"](port.state_dict()))
    batches = _batches(np.random.default_rng(2))

    jax32, _ = _jax_curve(jmodel, variables, jax_loss, batches, False)
    with _jax_float64():
        jax64, state = _jax_curve(jmodel, _f64(variables), jax_loss,
                                  [_f64(b) for b in batches], False)
        assert all(a.dtype == np.float64 for a in
                   jax.tree_util.tree_leaves(state.params))
    port64 = _port_curve(copy.deepcopy(port).double().train(), port_loss,
                         [_f64(b) for b in batches], False)
    port32 = _port_curve(port.train(), port_loss, batches, False)
    print(f"\nfloat32 against float64, relative loss gap a step: port "
          f"{_gaps(port32, port64)}, JAX {_gaps(jax32, jax64)}")

    _report("propnet float64", port64, jax64)
    np.testing.assert_allclose(port64[:, 0], jax64[:, 0], rtol=1e-5)
    _report("propnet float32 vs float64", port32, port64, held=2)

"""Training of ``tdnet`` and ``nonlocal3d`` in the port against the JAX
package, on the CPU.

(a) TDNet's loss curve: two steps of the clip trainer's step, at the
    trainer's first two ``pos_id`` (1, then 2: the target's path rotates),
    against the JAX trainer's (``make_train_step`` with ``pos_id`` static),
    rtol 1e-2, the accuracies within 1e-2.  Dropout is off on both sides:
    the port's by its override, JAX's FCN heads by theirs and the
    attention's two plain ``nn.Dropout`` (which no override reaches) by a
    flax method interceptor here.  Each JAX ``pos_id`` compiles a step of
    four ResNet-18 paths' forward and backward (~20 s), hence two steps;
    TDNet's training forward for every ``pos_id`` is in
    tests/test_torch_tdnet.py and Non-local 3D's curve in
    tests/test_torch_nonlocal3d.py;
(b) the port's trainer passes ``pos_id = (step + 1) % 4``;
(c) ``--pre_enc`` / ``--pre_dec`` against JAX's ``apply_pretrained_init``:
    Non-local 3D loads the encoder and has no decoder; TDNet has neither
    (JAX overlays the encoder checkpoint on an ``encoder`` subtree that its
    model never reads), so its weights stay as they are.
"""

import argparse
import logging

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2021_vspw_implement_tpu.models import layers as jlayers
from cvpr2021_vspw_implement_tpu.models import td4_psp as jtd
from cvpr2021_vspw_implement_tpu.models.import_torch import (
    apply_pretrained_init as jax_apply_pretrained_init,
    import_nonlocal3d_state_dict, import_td4_state_dict)
from cvpr2021_vspw_implement_tpu.parallel import TrainState, make_train_step
from cvpr2021_vspw_implement_tpu.parallel.optim import \
    create_clip_optimizer as jax_clip_optimizer
from cvpr2021_vspw_implement_tpu_torch import methods, train_clip
from cvpr2021_vspw_implement_tpu_torch.config import cfg as port_default_cfg
from cvpr2021_vspw_implement_tpu_torch.convert import load_jax_variables
from cvpr2021_vspw_implement_tpu_torch.data import make_synthetic_vspw
from cvpr2021_vspw_implement_tpu_torch.models import layers, td4_psp
from cvpr2021_vspw_implement_tpu_torch.parallel import (create_clip_optimizer,
                                                        to_device, train_step)
from cvpr2021_vspw_implement_tpu_torch.pretrained import apply_pretrained_init
from test_torch_pretrained_init import _checkpoints, _setup
from test_torch_tdnet import CROP, K, _models
from test_torch_train_ocr_netwarp import LR, MAX_ITERS, MOM, WD
from torch_port_util import numpy_tree

# (a) the curve

def _no_flax_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, flax.linen.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.fixture()
def no_dropout():
    jlayers.set_dropout_override(0.0)
    layers.set_dropout_override(0.0)
    yield
    jlayers.set_dropout_override(None)
    layers.set_dropout_override(None)


def test_tdnet_curve_matches_jax(no_dropout):
    port, jmodel, _ = _models()
    model = td4_psp.TD4PSP(K, cropsize=CROP)
    model.load_state_dict(port.state_dict())
    with torch.no_grad():
        # the classifiers start small (logits of a few units), as the
        # curves of tests/test_torch_train_ocr_netwarp.py
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d) and m.out_channels == K:
                m.weight.mul_(0.1)
    start = numpy_tree(import_td4_state_dict(model.state_dict()))
    rng = np.random.default_rng(4)
    batches, pos_ids = [], [1, 2]
    for _ in pos_ids:
        img = rng.standard_normal((4, 2, CROP, CROP, 3)).astype(np.float32)
        lab = rng.integers(0, K, (4, 2, CROP, CROP)).astype(np.int32)
        lab[:, :, 0, :3] = 255
        batches.append({"img": img, "labels": lab})

    tx = jax_clip_optimizer(start["params"], lr=LR, max_iters=MAX_ITERS,
                            momentum=MOM, weight_decay=WD)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, start), tx)
    step = make_train_step(jmodel, tx, loss_fn=jtd.td4_loss, donate=False,
                           static_kwarg="pos_id")
    want = []
    with flax.linen.intercept_methods(_no_flax_dropout):
        for batch, p in zip(batches, pos_ids):
            state, m = step(state, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                            jax.random.PRNGKey(0), p)
            want.append((float(m["loss"]), float(m["acc"])))
    want = np.array(want)

    optimizer, scheduler = create_clip_optimizer(
        model, lr=LR, max_iters=MAX_ITERS, momentum=MOM, weight_decay=WD)
    got = []
    for batch, p in zip(batches, pos_ids):
        m = train_step(model, optimizer, scheduler, to_device(batch, "cpu"),
                       td4_psp.td4_loss, pos_id=p)
        got.append((m["loss"].item(), m["acc"].item()))
    got = np.array(got)
    print(f"\ntdnet: port losses {got[:, 0]}, JAX losses {want[:, 0]}")
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-2)
    np.testing.assert_allclose(got[:, 1], want[:, 1], atol=1e-2)
    assert np.ptp(want[:, 0]) > 1e-3 * abs(want[0, 0])


# (b) the trainer's rotation

def test_trainer_rotates_pos_id(tmp_path, monkeypatch):
    root = str(tmp_path / "vspw")
    make_synthetic_vspw(root, 4, 6, (40, 56), K, seed=3, splits=("train",))
    cfg = port_default_cfg.clone()
    args = argparse.Namespace(
        method="tdnet", num_class=K, dataroot=root, clip_num=4,
        dilation_num=0, batchsize=2, cropsize=31, lr=0.01, totalepoch=2,
        weight_decay=1e-4, fix=False, resume_epoch=0, multi_scale=False,
        saveroot=str(tmp_path / "ckpt"), device="cpu", seed=0,
        validation=False, pre_enc="", pre_dec="")
    seen = []
    step = train_clip.train_step

    def recorded(*a, **kw):
        seen.append(kw.get("pos_id"))
        return step(*a, **kw)
    monkeypatch.setattr(train_clip, "train_step", recorded)
    train_clip.train_clip(cfg, args, max_steps=3)
    assert seen == [1, 2, 3]


# (c) the pretrained init

@pytest.mark.parametrize("method", ["nonlocal3d", "tdnet"])
def test_pretrained_init_matches_jax(tmp_path, method, caplog):
    enc, dec, donor = _checkpoints(tmp_path)
    args, cfg, jcfg = _setup("clip_psp", ["--pre_enc", enc, "--pre_dec", dec])
    args.method, args.clip_num, args.cropsize = method, 4, CROP
    importer = {"nonlocal3d": import_nonlocal3d_state_dict,
                "tdnet": import_td4_state_dict}[method]

    def seeded():
        model, _ = methods.build_method(method, cfg, args)
        layers.init_weights(model, torch.Generator().manual_seed(0))
        return model

    init = seeded().state_dict()
    merged = jax_apply_pretrained_init(importer(init), jcfg, args)
    want = load_jax_variables(seeded(), numpy_tree(merged)).state_dict()
    with caplog.at_level(logging.INFO):
        got = apply_pretrained_init(seeded(), cfg, args,
                                    logging.getLogger("pretrained")
                                    ).state_dict()
    assert got.keys() == want.keys()
    for name in got:
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(got[name], want[name]), name
    if method == "nonlocal3d":
        assert torch.equal(got["encoder.conv1.weight"],
                           donor.encoder.conv1.weight)
        assert torch.equal(got["last_layer.weight"],
                           init["last_layer.weight"])
        assert "no decoder" in caplog.text
    else:
        # JAX keeps the checkpoint in a subtree its TD4PSP never reads
        assert "encoder" in merged["params"]
        assert all(torch.equal(got[k], v) for k, v in init.items())
        assert "no encoder" in caplog.text and "no decoder" in caplog.text

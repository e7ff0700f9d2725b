"""The port's native host ops (``native``: its copy of hostops.cpp, built
under build/native/) against the JAX package's native module and numpy:
bitwise equal arrays, and the same arrays from the numpy fallback when the
library cannot be built."""

import glob
import os

import numpy as np

from cvpr2021_vspw_implement_tpu import native as jnative
from cvpr2021_vspw_implement_tpu_torch import native

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def _numpy_normalize(img):
    """p * (1/255/std) + (-mean/std), float32: the native op's roundings."""
    return img.astype(np.float32) * (np.float32(1 / 255) / STD) \
        + (-MEAN / STD)


def _numpy_remap(mask):
    out = mask.astype(np.int32) - 1
    out[mask == 0] = 255
    out[out == 254] = 255
    return out


def test_host_ops_bitwise_jax_and_numpy():
    assert native.status() == "native"
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (23, 31, 3), np.uint8)
    got = native.normalize_u8(img)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jnative.normalize_u8(img))
    np.testing.assert_array_equal(got, _numpy_normalize(img))
    np.testing.assert_array_equal(got, native.normalize_numpy(img))
    mask = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for remap in (jnative.remap_label_u8, _numpy_remap, native.remap_numpy):
        np.testing.assert_array_equal(native.remap_label_u8(mask),
                                      remap(mask))
    # a non-contiguous view is read as its values
    view = img[:, ::2]
    np.testing.assert_array_equal(native.normalize_u8(view),
                                  _numpy_normalize(view))


def test_library_built_under_build_native():
    native.status()
    import shutil
    path = native.library_path(shutil.which("g++"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    assert native.BUILD_DIR == os.path.join(os.path.dirname(repo), "build",
                                            "native")
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libhostops-")
    assert not glob.glob(os.path.join(os.path.dirname(native.__file__),
                                      "*.so"))


def test_library_name_follows_the_compiler(tmp_path):
    """Another compiler (its ``--version``) gives another library, so one
    built elsewhere is not loaded in place of this compiler's."""
    names = []
    for version in ("g++ (A) 12.2.0", "g++ (B) 13.1.0"):
        fake = tmp_path / f"gxx-{len(names)}"
        fake.write_text(f"#!/bin/sh\necho '{version}'\n")
        fake.chmod(0o755)
        names.append(native.library_path(str(fake)))
    assert names[0] != names[1]
    assert names[0] == native.library_path(str(tmp_path / "gxx-0"))


def test_fallback_without_a_toolchain(monkeypatch, tmp_path):
    """No g++: ``status`` says so and normalize and remap take numpy, with
    the native path's arrays."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (9, 11, 3), np.uint8)
    mask = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = native.normalize_u8(img), native.remap_label_u8(mask)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_status", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "none"))
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    assert native.status().startswith("fallback (g++ not found")
    np.testing.assert_array_equal(native.normalize_u8(img), want[0])
    np.testing.assert_array_equal(native.remap_label_u8(mask), want[1])
    assert not os.path.exists(tmp_path / "none")

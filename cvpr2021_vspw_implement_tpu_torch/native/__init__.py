"""Native host ops of the input pipeline, loaded with ctypes (a copy of the
JAX package's native/hostops.cpp): the uint8 → ImageNet-normalized float32
pass and the VSPW label remap, one pass each.

The library is built with ``g++ -O3 -shared -fPIC`` on first use, into
``build/native/`` at the repository root, named by a digest of its source,
its flags and the compiler's ``--version``, so an edited source or another
compiler gives another library; nothing is written into the package.  Where
``g++`` is missing or the build fails, both entry points take numpy, which
gives bitwise the same arrays.  Which path was taken is logged once
(:func:`status`).  JPEGs decode with PIL (``data.datasets.load_frame``).
These are host ops: nothing here touches the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_DIR, "hostops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
FLAGS = ("-O3", "-shared", "-fPIC")
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)

_lib = None
#: "native", or "fallback (reason)" once the first call has decided
_status: str | None = None
_lock = threading.Lock()
_fp = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)


def library_path(gxx: str) -> str:
    """Where ``gxx`` builds the library: named by the digest of the source,
    the flags and ``gxx --version``."""
    version = subprocess.run([gxx, "--version"], capture_output=True,
                             text=True).stdout
    digest = hashlib.sha1("\n".join(FLAGS + (version,)).encode())
    with open(_SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libhostops-{digest.hexdigest()[:12]}.so")


def _build(force: bool = False) -> str:
    """Compile the library unless it exists (or ``force``); the output is
    written to a temporary file and renamed, so a concurrent process never
    loads half a library.  Returns its path; raises if there is no g++ or
    it fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    path = library_path(gxx)
    if os.path.exists(path) and not force:
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([gxx, *FLAGS, _SOURCE, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed: {proc.stderr.strip()[-400:]}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load():
    """The loaded library, or None where it cannot be built or loaded (the
    first call decides, and logs its decision)."""
    global _lib, _status
    if _status is not None:
        return _lib
    with _lock:
        if _status is not None:
            return _lib
        try:
            try:
                lib = ctypes.CDLL(_build())
            except OSError:       # a library that does not load here
                lib = ctypes.CDLL(_build(force=True))
            lib.normalize_u8.argtypes = [_u8p, _fp, ctypes.c_size_t, _fp, _fp]
            lib.remap_label_u8.argtypes = [_u8p, _i32p, ctypes.c_size_t]
            _lib, _status = lib, "native"
        except Exception as e:   # the fallback is the numpy path
            _status = f"fallback ({str(e).splitlines()[0][:200]})"
        logging.getLogger("Logger").info(
            "native hostops: " + ("built and loaded" if _lib is not None else
                                  f"{_status}; using numpy"))
    return _lib


def status() -> str:
    """"native", or "fallback (reason)"; loads the library first."""
    _load()
    return _status


def normalize_numpy(img: np.ndarray) -> np.ndarray:
    """The numpy path of :func:`normalize_u8`: p * (1/255/std) - mean/std in
    float32, the native op's two roundings."""
    scale = np.float32(1.0 / 255.0) / _STD
    return img.astype(np.float32) * scale + (-_MEAN / _STD)


def remap_numpy(mask: np.ndarray) -> np.ndarray:
    """The numpy path of :func:`remap_label_u8`."""
    out = mask.astype(np.int32) - 1
    out[mask == 0] = 255
    out[out == 254] = 255
    return out


def normalize_u8(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] → ImageNet-normalized float32 in one pass."""
    img = np.ascontiguousarray(img, np.uint8)
    lib = _load()
    if lib is None:
        return normalize_numpy(img)
    out = np.empty(img.shape, np.float32)
    lib.normalize_u8(img.ctypes.data_as(_u8p), out.ctypes.data_as(_fp),
                     img.size // 3, _MEAN.ctypes.data_as(_fp),
                     _STD.ctypes.data_as(_fp))
    return out


def remap_label_u8(mask: np.ndarray) -> np.ndarray:
    """uint8 mask → int32: 0 → 255, v → v - 1, 254 → 255."""
    mask = np.ascontiguousarray(mask, np.uint8)
    lib = _load()
    if lib is None:
        return remap_numpy(mask)
    out = np.empty(mask.shape, np.int32)
    lib.remap_label_u8(mask.ctypes.data_as(_u8p), out.ctypes.data_as(_i32p),
                       mask.size)
    return out

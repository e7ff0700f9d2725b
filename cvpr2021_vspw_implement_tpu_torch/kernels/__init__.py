"""Builds and loads the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/kernels/`` at the repository root,
on first use, and loaded with ``ctypes``.  The library name carries a hash
of the source, of every header under ``csrc/`` (sources share device code
through them) and of the flags, so an edited file is rebuilt.  Nothing here
runs at import time: this module is imported on hosts without ``nvcc``.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.

The launch path is the host's cost of every kernel call, and for the small
kernels (B1, B6) it is longer than the kernel: a wrapper takes its entry
point from :func:`entry` (one dict lookup once resolved, no lock) and the
raw handle of PyTorch's current stream from :func:`stream` (no
``torch.cuda.Stream`` object a call).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry points of each source and their argument types
SIGNATURES = {
    "corr_lookup": {
        "corr_lookup_f32": [_P] * 4 + [_I] * 9 + [_P, _P, _I, _I, _P],
    },
    "sep_gru": {
        "sep_gru_pass_f32": [_P] * 9 + [_I] * 6 + [_P],
    },
    "motion_encoder": {
        "motion_encoder_f32": [_P] * 14 + [_I] * 4 + [_P],
    },
    "gru_flowhead": {
        "gru_flowhead_f32": [_P] * 17 + [_I] * 6 + [_P],
    },
    "band_zero": {
        "band_zero_f32": [_P] + [_I] * 5 + [_P],
    },
    "local_agg": {
        "local_sigmoid_agg_f32": [_P] * 4 + [_I] * 8 + [_P],
        "local_softmax_agg_f32": [_P] * 4 + [_I] * 8 + [_F, _P],
        "local_nearest_agg_f32": [_P] * 5 + [_I] * 8 + [_P],
    },
    "local_agg_bwd": {
        "local_sigmoid_agg_bwd_f32": [_P] * 9 + [_I] * 6 + [_P],
        "local_softmax_agg_bwd_f32": [_P] * 9 + [_I] * 6 + [_F, _P],
        "local_nearest_agg_bwd_f32": [_P] * 3 + [_I] * 5 + [_P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: C entry point name -> its source's name
_SOURCE_OF = {fn: name for name, fns in SIGNATURES.items() for fn in fns}
#: C entry point name -> the resolved ctypes function
_entries: dict = {}


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not path:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return path


def library_path(name: str) -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, name + ".cu"),
                 *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet, all
    ``nvcc`` processes at once.  Returns {name: compiler output} for the
    ones compiled; raises with the compiler output if one fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    nvcc = None
    for name in names:
        so = library_path(name)
        if os.path.exists(so):
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    logs, failed = {}, []
    for name, (proc, tmp, so) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, so)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(library_path(name))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def entry(fn: str):
    """The ctypes function of C entry point ``fn``, its library built and
    loaded at the first call; later calls are one dict lookup."""
    f = _entries.get(fn)
    if f is None:
        f = _entries[fn] = getattr(load(_SOURCE_OF[fn]), fn)
    return f


def stream(device_index: int) -> int:
    """The raw handle of PyTorch's current CUDA stream on device
    ``device_index`` (the capturing stream under a CUDA graph capture),
    without building a ``torch.cuda.Stream``, which costs several us a
    call.  A PyTorch without the private getter raises here rather than
    take the slow path."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def check_inputs(what: str, tensors) -> None:
    """Raise unless every tensor is contiguous float32 on the first one's
    device: the kernels take raw pointers."""
    dev = tensors[0].device
    for t in tensors:
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{what}: inputs must be contiguous float32 on "
                             f"{dev}")


def check_aligned(what: str, tensors) -> None:
    """Raise unless every tensor starts on a 16-byte boundary: the
    tensor-core kernels copy weights 16 bytes at a time."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: weights must start on a 16-byte "
                             "boundary")


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


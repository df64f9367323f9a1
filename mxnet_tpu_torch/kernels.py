"""Build, load and count the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with :mod:`ctypes`. Libraries land in ``_build/``
beside this file, named by a hash of the source, so an unchanged source
is compiled once per checkout; :func:`build_all` starts one ``nvcc`` per
source at once. Nothing is built or loaded at import: the first launch
of a kernel builds its library, or :func:`build_all` builds them all up
front.

Two process-wide counters: :func:`build_count` counts library builds and
loads (the port's ``compile_count``; it must not move after an engine's
``warmup()``), and :func:`launch_counts` counts kernel launches per
kernel, incremented by each wrapper where it launches its kernel and
nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["SOURCES", "build_all", "library", "launch_counts",
           "reset_launch_counts", "count_launch", "build_count",
           "check", "require", "stream_handle"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points per source: name -> argtypes (every one returns the
# launch's cudaError_t as an int)
SOURCES = {
    "ragged_flat": {
        "mxt_ragged_flat_f32": [_P] * 7 + [_I] * 7 + [_F, _P],
        "mxt_ragged_flat_int8": [_P] * 9 + [_I] * 7 + [_F, _P],
        "mxt_ragged_flat_fp8": [_P] * 9 + [_I] * 7 + [_F, _P],
    },
    "wq_matmul": {
        "mxt_wq_matmul_int8": [_P] * 5 + [_I] * 4 + [_P],
        "mxt_wq_matmul_fp8": [_P] * 5 + [_I] * 4 + [_P],
    },
}

_lock = threading.Lock()
_libs = {}                      # guarded-by: _lock
_builds = [0]                   # guarded-by: _lock
_launches = collections.Counter()
# what nvcc/ptxas said for each source (registers, spills)
build_logs = {}


def build_count():
    """Library builds + loads in this process."""
    return _builds[0]


def count_launch(name):
    _launches[name] += 1


def launch_counts():
    return dict(_launches)


def reset_launch_counts():
    _launches.clear()


def _nvcc():
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the port's CUDA kernels are built from csrc/ at first use")
    return cand


def _target(name):
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR,
                             f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name):
    """Start nvcc for ``name`` unless its library is already built;
    returns (popen or None, output path)."""
    src, out = _target(name)
    if os.path.exists(out):
        return None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), out


def _wait(name, started, out):
    """Wait for a build started by :func:`_start`; True when it failed
    (its output is in ``build_logs``)."""
    if started is None:
        return False
    proc, tmp = started
    build_logs[name], _ = proc.communicate()
    if proc.returncode != 0:
        return True
    os.replace(tmp, out)
    return False


def _load(name, out):
    lib = ctypes.CDLL(out)
    for fn, argtypes in SOURCES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _libs[name] = lib
    _builds[0] += 1
    return lib


def build_all():
    """Build (in parallel) and load every kernel library not yet
    loaded in this process. Returns the names it loaded."""
    with _lock:
        todo = [n for n in SOURCES if n not in _libs]
        started = [(n,) + _start(n) for n in todo]
        # wait for every nvcc before raising, so none outlives the call
        failed = [n for n, st, out in started if _wait(n, st, out)]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"csrc/{n}.cu:\n{build_logs[n]}" for n in failed))
        for name, _, out in started:
            _load(name, out)
        return todo


def library(name):
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            started, out = _start(name)
            if _wait(name, started, out):
                raise RuntimeError(
                    f"nvcc failed on csrc/{name}.cu:\n{build_logs[name]}")
            _load(name, out)
        return _libs[name]


def stream_handle(device):
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(rc, what):
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def require(t, name, dtype, shape, device):
    """Raise unless tensor ``t`` is on ``device`` with ``dtype``,
    ``shape`` and a contiguous layout — what a kernel takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")

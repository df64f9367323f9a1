"""Build, load and count the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with :mod:`ctypes`. Libraries land in ``_build/``
beside this file, named by a hash of the source, so an unchanged source
is compiled once per checkout (the hash covers the shared headers,
``csrc/*.cuh``, too); :func:`build_all` starts one ``nvcc`` per source
at once. Nothing is built or loaded at import: the first launch
of a kernel builds its library, or :func:`build_all` builds them all up
front.

Process-wide counters: :func:`build_count` counts library builds and
loads and :func:`capture_count` CUDA graph captures (together the port's
``compile_count``; neither may move after an engine's ``warmup()``; each
also reports to ``mxtpu_xla_compile_total`` with its seconds,
``observability/compilemon.py``), and
:func:`launch_counts` counts kernel launches per kernel, incremented by
each wrapper where it launches its kernel and nowhere else.

Under a CUDA graph a wrapper's Python runs once, at the capture, and the
kernel at every replay. So :func:`capture` records the launches of its
capture into the graph's tally instead of the counters, and each
:meth:`CapturedGraph.replay` adds that tally: the counts stay the
kernels' launches on the card.
"""
from __future__ import annotations

import collections
import ctypes
import gc
import hashlib
import os
import shutil
import subprocess
import threading
import time

from .observability import compilemon

__all__ = ["SOURCES", "build_all", "library", "rtc_library",
           "launch_counts", "reset_launch_counts", "count_launch",
           "build_count", "capture_count", "warm", "capture", "CapturedGraph",
           "CaptureError", "check", "require", "stream_handle"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points per source: name -> argtypes (every one returns the
# launch's cudaError_t as an int)
SOURCES = {
    # the paged kernels over f32, int8 and fp8 pages; q's dtype (0 f32, 1
    # bf16, 2 f16) is the int before the scale, the flat kernels' page
    # order (1 dealt) the int before it
    "ragged_flat": {
        "mxt_ragged_flat_f32": [_P] * 7 + [_I] * 14 + [_F, _P],
        "mxt_ragged_flat_int8": [_P] * 9 + [_I] * 14 + [_F, _P],
        "mxt_ragged_flat_fp8": [_P] * 9 + [_I] * 14 + [_F, _P],
        "mxt_ragged_chunk_f32": [_P] * 7 + [_I] * 12 + [_F, _P],
        "mxt_ragged_decode_f32": [_P] * 6 + [_I] * 11 + [_F, _P],
    },
    # the same kernels over bf16 and f16 pages, with the same q dtypes
    "ragged_flat_lp": {
        f"mxt_ragged_{kernel}_{dt}": args
        for dt in ("bf16", "f16")
        for kernel, args in (("flat", [_P] * 7 + [_I] * 14 + [_F, _P]),
                             ("chunk", [_P] * 7 + [_I] * 12 + [_F, _P]),
                             ("decode", [_P] * 6 + [_I] * 11 + [_F, _P]))
    },
    # x's dtype (0 f32, 1 bf16, 2 f16) is the int before the stream
    "wq_matmul": {
        "mxt_wq_matmul_int8": [_P] * 4 + [_I] * 8 + [_P],
        "mxt_wq_matmul_fp8": [_P] * 4 + [_I] * 8 + [_P],
    },
    "flash_attention": {
        "mxt_flash_fwd_f32": [_P] * 6 + [_I] * 6 + [_F, _P],
        "mxt_flash_dkv_f32": [_P] * 10 + [_I] * 6 + [_F, _P],
        "mxt_flash_dq_f32": [_P] * 8 + [_I] * 6 + [_F, _P],
    },
    # the 16-bit backward (TMA and wgmma) on bf16 and f16 q/k/v/dout
    "flash_bwd_lp_sm90": {
        f"mxt_flash_{kernel}_{dt}": args
        for dt in ("bf16", "f16")
        for kernel, args in (("dkv", [_P] * 10 + [_I] * 6 + [_F, _P]),
                             ("dq", [_P] * 8 + [_I] * 6 + [_F, _P]))
    },
    # the 16-bit forward (TMA and wgmma)
    "flash_fwd_lp_sm90": {
        f"mxt_flash_fwd_{dt}": [_P] * 6 + [_I] * 6 + [_F, _P]
        for dt in ("bf16", "f16")
    },
    # the optimizer update ops over a launch table: rule, weight dtype,
    # table, tensors, chunks, scalar rows, stream
    "multi_tensor_update": {
        "mxt_multi_tensor_update": [_I, _I, _P, _I, ctypes.c_longlong, _P,
                                    _P],
    },
}

_lock = threading.Lock()
_libs = {}                      # guarded-by: _lock
_builds = [0]                   # guarded-by: _lock
_captures = [0]                 # guarded-by: _lock
_launches = collections.Counter()
# the launch tally of the graph capture running on this thread, if any
_capturing = threading.local()
# capture stream handle -> its tally: a launch from another thread onto a
# capturing stream (the autograd engine's, running a captured backward)
# goes to that capture's tally
_stream_tallies = {}
# what nvcc/ptxas said for each source (registers, spills), and the
# seconds its nvcc ran
build_logs = {}
build_seconds = {}


def build_count():
    """Library builds + loads in this process."""
    return _builds[0]


def capture_count():
    """CUDA graph captures (:func:`capture`) in this process."""
    return _captures[0]


def count_launch(name):
    """One launch of kernel ``name``: counted, or, while this thread
    captures a graph (or launches onto a stream another thread is
    capturing), tallied for the graph's replays."""
    tally = getattr(_capturing, "tally", None)
    if tally is None and _stream_tallies:
        import torch
        tally = _stream_tallies.get(torch.cuda.current_stream().cuda_stream)
    (_launches if tally is None else tally)[name] += 1


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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR,
                             f"{name}-{digest.hexdigest()[:16]}.so")


def _start(src, out):
    """Start nvcc on ``src`` unless ``out`` is already built; returns
    (popen, temporary path, and the thread that collects nvcc's output
    and its seconds into a dict), or None."""
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.monotonic()
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    done = {}

    def reap():
        done["log"], _ = proc.communicate()
        done["seconds"] = time.monotonic() - t0
    reaper = threading.Thread(target=reap)
    reaper.start()
    return proc, tmp, reaper, done


def _wait(name, started, out):
    """Wait for a build started by :func:`_start`; True when it failed
    (its output is in ``build_logs``)."""
    if started is None:
        return False
    proc, tmp, reaper, done = started
    reaper.join()
    build_logs[name] = done["log"]
    build_seconds[name] = done["seconds"]
    if proc.returncode != 0:
        return True
    os.replace(tmp, out)
    return False


def _load(name, out, entries, built):
    """Load the library at ``out``; ``built`` says whether nvcc just made
    it (else it was found prebuilt in ``_build/``, a cache hit)."""
    t0 = time.monotonic()
    lib = ctypes.CDLL(out)
    for fn, argtypes in entries.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _libs[name] = lib
    _builds[0] += 1
    seconds = time.monotonic() - t0
    compilemon.note_compile(
        seconds + (build_seconds[name] if built else 0.0),
        cache_hit=not built)
    return lib


def build_all():
    """Build (in parallel) and load every kernel library not yet
    loaded in this process. Returns the names it loaded."""
    with _lock:
        todo = [n for n in SOURCES if n not in _libs]
        started = []
        for n in todo:
            src, out = _target(n)
            started.append((n, _start(src, out), out))
        # wait for every nvcc before raising, so none outlives the call
        failed = [n for n, st, out in started if _wait(n, st, out)]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"csrc/{n}.cu:\n{build_logs[n]}" for n in failed))
        for name, st, out in started:
            _load(name, out, SOURCES[name], st is not None)
        return todo


def library(name):
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            src, out = _target(name)
            started = _start(src, out)
            if _wait(name, started, out):
                raise RuntimeError(
                    f"nvcc failed on csrc/{name}.cu:\n{build_logs[name]}")
            _load(name, out, SOURCES[name], started is not None)
        return _libs[name]


# appended to a caller's source: launches its kernel by address, so the
# stub never needs the kernel's argument types
_RTC_STUB = """
#include <cuda_runtime.h>
extern "C" int mxt_rtc_launch(void** args, unsigned int gx, unsigned int gy,
                              unsigned int gz, unsigned int bx,
                              unsigned int by, unsigned int bz,
                              void* stream) {
  cudaError_t e = cudaLaunchKernel((const void*)(@KERNEL@), dim3(gx, gy, gz),
                                   dim3(bx, by, bz), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
"""
_RTC_ENTRIES = {"mxt_rtc_launch": [_P] + [ctypes.c_uint] * 6 + [_P]}


def rtc_library(source, kernel_name):
    """The loaded library for a caller's CUDA ``source`` string whose
    ``__global__`` function ``kernel_name`` is launched by the generated
    entry point ``mxt_rtc_launch(args, gx, gy, gz, bx, by, bz, stream)``
    (``args``: the kernel's argument pointers, as ``cudaLaunchKernel``
    takes them). Built by nvcc into ``_build/rtc-<hash>.so`` at first
    use, the hash taken over the source, the kernel name and the flags,
    so the same source is built once per checkout and loaded once per
    process."""
    if not kernel_name.isidentifier():
        raise ValueError(f"kernel_name must be a C identifier, got "
                         f"{kernel_name!r}")
    text = source + _RTC_STUB.replace("@KERNEL@", kernel_name)
    digest = hashlib.sha256(text.encode() + " ".join(NVCC_FLAGS).encode())
    name = f"rtc-{digest.hexdigest()[:16]}"
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            src = os.path.join(BUILD_DIR, name + ".cu")
            out = os.path.join(BUILD_DIR, name + ".so")
            if not os.path.exists(out):
                os.makedirs(BUILD_DIR, exist_ok=True)
                with open(src, "w") as f:
                    f.write(text)
            started = _start(src, out)
            if _wait(name, started, out):
                raise RuntimeError(
                    f"nvcc failed on the source of {kernel_name}:\n"
                    f"{build_logs[name]}")
            _load(name, out, _RTC_ENTRIES, started is not None)
        return _libs[name]


class CaptureError(RuntimeError):
    """A CUDA graph capture, or the warm run before it (which builds
    and loads the kernels the graph launches), failed."""


class CapturedGraph:
    """A captured ``torch.cuda.CUDAGraph`` and the kernel launches its
    capture recorded (``tally``, by kernel name); :meth:`replay` adds the
    tally to :func:`launch_counts` each time."""

    def __init__(self, graph, tally):
        self.graph = graph
        self.tally = dict(tally)

    def replay(self):
        self.graph.replay()
        _launches.update(self.tally)


def warm(fn, stream, what="the function"):
    """Run ``fn()`` once, eagerly, on the side stream ``stream`` (ordered
    after the current stream's work, and the current stream after it),
    as the warm run before a capture on that stream: it builds and loads
    every kernel ``fn`` launches and sets up the stream's library state
    (cuBLAS's workspace) outside any capture. Returns what ``fn``
    returns; an exception raises :class:`CaptureError` naming ``what``."""
    import torch
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    try:
        with torch.cuda.stream(stream):
            out = fn()
    except Exception as exc:
        raise CaptureError(f"the warm run before the CUDA graph capture "
                           f"of {what} failed: {exc}") from exc
    finally:
        current.wait_stream(stream)
    return out


def capture(fn, stream, pool=None, what="the function", warmed=False,
            generators=()):
    """Capture ``fn()`` into a CUDA graph on the side stream ``stream``
    and return it as a :class:`CapturedGraph`.

    One eager warm run of ``fn`` on ``stream`` comes first (PyTorch's
    recipe, :func:`warm`) unless ``warmed`` says the caller made it on
    ``stream`` already: it builds and loads every kernel ``fn`` launches,
    so no build runs inside the capture, and its launches count. Captures
    that share a graph memory pool ``pool`` (a
    ``torch.cuda.graph_pool_handle()``, or another graph's ``pool()``;
    graphs that never replay at once may share one) share ``stream``
    too: the stream's library state (cuBLAS's workspace) is set up once,
    by the first warm run, outside any capture. ``generators`` (the CUDA
    generators ``fn`` draws from besides torch's default one, which the
    capture registers itself) are registered with the graph,
    so each replay advances their offsets and draws anew. The capture
    runs with ``capture_error_mode="thread_local"``, so it may run on a
    server's thread; its launches go to the graph's tally, not the
    counters, and it counts once in :func:`capture_count`. The warm run
    is a real run: what ``fn`` reads must already hold what the caller
    means, and what it writes stays written. Tensors ``fn`` reads must
    stay where they are: the graph replays on their addresses. A failed
    warm run or capture raises :class:`CaptureError` naming ``what``."""
    import torch
    t0 = time.monotonic()
    if not warmed:
        warm(fn, stream, what)
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    _capturing.tally = tally = collections.Counter()
    handle = getattr(stream, "cuda_stream", None)
    if handle is not None:
        _stream_tallies[handle] = tally
    # no garbage collection inside the capture: a collected graph (say, a
    # dropped block's) destroys itself with calls a capture forbids
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            fn()
    except Exception as exc:
        raise CaptureError(
            f"CUDA graph capture of {what} failed: {exc}") from exc
    finally:
        if collecting:
            gc.enable()
        _capturing.tally = None
        _stream_tallies.pop(handle, None)
    with _lock:
        _captures[0] += 1
    compilemon.note_compile(time.monotonic() - t0)
    return CapturedGraph(graph, tally)


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

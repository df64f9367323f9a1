"""Native (C++) components of the data path, loaded with :mod:`ctypes`
(mirrors ``mxnet_tpu/native/__init__.py``, without the C predict shim).

The reference implements its data pipeline in C++ (dmlc-core recordio +
``src/io/`` prefetching iterators); ``src/`` holds the port's copies of
those sources: ``recordio_native.cpp`` (the record reader and its
prefetch thread) and ``imagepipe_native.cpp`` (the decode/augment worker
pool over OpenCV's C++ libraries). Each builds with g++ at first use into
``mxnet_tpu_torch/_build/``, under a name that hashes the source and the
flags, so an edit rebuilds and a checkout never loads a stale library.
A build writes a temporary file of its own process and thread and then
renames it into place: processes that build at once (test workers) each
finish with a whole library and none fails or skips.

Every caller keeps a pure-Python path for a host without the toolchain
(or OpenCV); ``MXNET_TPU_NATIVE=0`` forces it, as in the reference.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

__all__ = ["recordio_lib", "imagepipe_lib", "native_enabled",
           "library_path", "build_library", "NativeRecordReader",
           "NativePrefetchReader"]

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
_OPENCV = ("-I/usr/include/opencv4", "-lopencv_core", "-lopencv_imgcodecs",
           "-lopencv_imgproc")
_SOURCES = {"recordio_native": (), "imagepipe_native": _OPENCV}

_lock = threading.Lock()
_libs = {}          # name -> CDLL or None; guarded-by: _lock
last_build_error = {}


def native_enabled() -> bool:
    return os.environ.get("MXNET_TPU_NATIVE", "1") != "0"


def library_path(name):
    """Where the library of ``src/<name>.cpp`` lands: ``_build/lib<name>-
    <hash of source and flags>.so``."""
    src = os.path.join(_DIR, "src", name + ".cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(_FLAGS + _SOURCES[name]).encode())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_library(name):
    """Build ``src/<name>.cpp`` unless its library is there; returns the
    library's path. Raises ``CalledProcessError`` (g++'s output in
    ``stderr``) on a failed build."""
    src, so = library_path(name)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, src, "-o", tmp, *_SOURCES[name]],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def _load(name, declare):
    """The library ``name``, built and declared once a process, or None
    (disabled, or the build failed: ``last_build_error[name]`` says why).
    Thread-safe."""
    if not native_enabled():   # honoured per call, not only at first load
        return None
    if name in _libs:
        return _libs[name]
    with _lock:
        if name not in _libs:
            try:
                lib = ctypes.CDLL(build_library(name))
                declare(lib)
            except (OSError, subprocess.CalledProcessError) as e:
                last_build_error[name] = getattr(e, "stderr", None) or str(e)
                lib = None
            _libs[name] = lib
    return _libs[name]


def _declare_recordio(lib):
    bufp = ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte))
    lib.rio_open_reader.restype = ctypes.c_void_p
    lib.rio_open_reader.argtypes = [ctypes.c_char_p]
    lib.rio_read.restype = ctypes.c_long
    lib.rio_read.argtypes = [ctypes.c_void_p, bufp]
    lib.rio_read_at.restype = ctypes.c_long
    lib.rio_read_at.argtypes = [ctypes.c_void_p, ctypes.c_long, bufp]
    lib.rio_seek.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.rio_tell.restype = ctypes.c_long
    lib.rio_tell.argtypes = [ctypes.c_void_p]
    lib.rio_error.restype = ctypes.c_char_p
    lib.rio_error.argtypes = [ctypes.c_void_p]
    lib.rio_close.argtypes = [ctypes.c_void_p]
    lib.rio_open_prefetch.restype = ctypes.c_void_p
    lib.rio_open_prefetch.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.rio_pf_read.restype = ctypes.c_long
    lib.rio_pf_read.argtypes = [ctypes.c_void_p, bufp]
    lib.rio_pf_close.argtypes = [ctypes.c_void_p]


def _declare_imagepipe(lib):
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.ip_create.restype = ctypes.c_void_p
    lib.ip_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, f32p, f32p, ctypes.c_int]
    lib.ip_start_epoch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_uint32]
    lib.ip_next_batch.restype = ctypes.c_long
    lib.ip_next_batch.argtypes = [ctypes.c_void_p, f32p, f32p]
    lib.ip_error_count.restype = ctypes.c_long
    lib.ip_error_count.argtypes = [ctypes.c_void_p]
    lib.ip_last_error.restype = ctypes.c_char_p
    lib.ip_last_error.argtypes = [ctypes.c_void_p]
    lib.ip_destroy.argtypes = [ctypes.c_void_p]


def recordio_lib():
    """The compiled recordio library, or None (no toolchain / disabled)."""
    return _load("recordio_native", _declare_recordio)


def imagepipe_lib():
    """The compiled decode/augment pipeline (needs the system OpenCV C++
    libraries, the same dependency the reference's C++ ImageRecordIter
    has), or None."""
    return _load("imagepipe_native", _declare_imagepipe)


class NativeRecordReader:
    """Sequential/indexed reader over the C++ core."""

    def __init__(self, path):
        lib = recordio_lib()
        if lib is None:
            raise RuntimeError("native recordio unavailable")
        self._lib = lib
        self._h = lib.rio_open_reader(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path!r}")

    def _got(self, n, buf):
        if n == -1:
            return None
        if n < 0:
            raise IOError(self._lib.rio_error(self._h).decode())
        return ctypes.string_at(buf, n)

    def read(self):
        buf = ctypes.POINTER(ctypes.c_ubyte)()
        return self._got(self._lib.rio_read(self._h, ctypes.byref(buf)), buf)

    def read_at(self, pos):
        buf = ctypes.POINTER(ctypes.c_ubyte)()
        return self._got(self._lib.rio_read_at(self._h, pos,
                                               ctypes.byref(buf)), buf)

    def seek(self, pos):
        self._lib.rio_seek(self._h, pos)

    def tell(self):
        return self._lib.rio_tell(self._h)

    def close(self):
        if self._h:
            self._lib.rio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativePrefetchReader:
    """Background-thread prefetching reader (the C++ thread reads ahead
    ``queue_size`` records while Python consumes)."""

    def __init__(self, path, queue_size=64):
        lib = recordio_lib()
        if lib is None:
            raise RuntimeError("native recordio unavailable")
        self._lib = lib
        self._h = lib.rio_open_prefetch(path.encode(), int(queue_size))
        if not self._h:
            raise IOError(f"cannot open {path!r}")

    def read(self):
        buf = ctypes.POINTER(ctypes.c_ubyte)()
        n = self._lib.rio_pf_read(self._h, ctypes.byref(buf))
        if n == -1:
            return None
        if n < 0:
            raise IOError("prefetch reader failed")
        return ctypes.string_at(buf, n)

    def __iter__(self):
        while True:
            rec = self.read()
            if rec is None:
                return
            yield rec

    def close(self):
        if self._h:
            self._lib.rio_pf_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

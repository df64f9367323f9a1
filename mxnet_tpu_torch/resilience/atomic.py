"""Crash-safe file writes: temp file + flush/fsync + ``os.replace`` (the
port of ``mxnet_tpu/resilience/atomic.py``).

A checkpoint reader must never observe a half-written file. POSIX gives
exactly one primitive with that guarantee — ``rename(2)`` within a
filesystem is atomic — so every durable write of the port (the flight
recorder's bundles) goes:

    open(dir/.tmp-<name>-<pid>) → write → flush → fsync(file)
        → os.replace(tmp, dir/name) → fsync(dir)

The final directory fsync makes the *rename itself* durable (without it
a power cut can resurrect the old directory entry). Temp names carry a
recognizable prefix so checkpoint scanners skip strays left by killed
processes.

The write stream is routed through :mod:`.faults` so tests can abort it
at byte N; on :class:`~.faults.InjectedCrash` the temp file is left on
disk — a dead process cannot clean up after itself, and readers must
cope.
"""
from __future__ import annotations

import contextlib
import os
import zlib

from . import faults

__all__ = ["atomic_write", "TMP_PREFIX", "is_temp_path", "fsync_dir",
           "crc32_file"]

TMP_PREFIX = ".tmp-"


def is_temp_path(path) -> bool:
    """True for in-flight temp files the atomic writer may leave behind."""
    return os.path.basename(str(path)).startswith(TMP_PREFIX)


def fsync_dir(dirname):
    """fsync a directory so a completed rename survives power loss.
    Best-effort: not all filesystems/platforms allow opening a dir."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class _Sink:
    """Write wrapper accumulating crc32/byte-count for manifests."""

    def __init__(self, f):
        self._f = f
        self.crc32 = 0
        self.nbytes = 0

    def write(self, data):
        self._f.write(data)
        # after a successful write only: an injected crash mid-write must
        # not count bytes the reader may never see
        self.crc32 = zlib.crc32(data, self.crc32)
        self.nbytes += len(data)

    def __getattr__(self, item):
        return getattr(self._f, item)


@contextlib.contextmanager
def atomic_write(path, mode: str = "wb"):
    """Context manager yielding a file-like sink; on clean exit the data
    is atomically published at ``path`` (crash anywhere before the final
    rename leaves ``path`` untouched).

    The yielded sink exposes ``crc32`` and ``nbytes`` of the written
    stream after the block exits, for manifest bookkeeping::

        with atomic_write(p) as f:
            f.write(payload)
        manifest["crc32"] = f.crc32

    On an ordinary exception the temp file is removed; on an injected
    crash (:class:`faults.InjectedCrash`) it is deliberately left behind
    to mirror a killed process.
    """
    path = os.fspath(path)
    dirname = os.path.dirname(path) or "."
    tmp = os.path.join(
        dirname, f"{TMP_PREFIX}{os.path.basename(path)}-{os.getpid()}")
    f = open(tmp, mode)
    sink = _Sink(faults.wrap_file(f, path))
    try:
        yield sink
        f.flush()
        os.fsync(f.fileno())
    except faults.InjectedCrash:
        with contextlib.suppress(OSError):
            f.close()
        raise
    except BaseException:
        with contextlib.suppress(OSError):
            f.close()
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise
    f.close()
    # the publish boundary: a crash here (fully-written temp, rename
    # never issued) is the "mid-manifest rename" failure mode — the temp
    # stays behind and readers still see the previous contents
    faults.point(f"atomic.replace:{os.path.basename(path)}")
    os.replace(tmp, path)
    fsync_dir(dirname)


def crc32_file(path, chunk=1 << 20):
    """(crc32, nbytes) of a file's contents, streamed."""
    crc = 0
    n = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            crc = zlib.crc32(b, crc)
            n += len(b)
    return crc, n

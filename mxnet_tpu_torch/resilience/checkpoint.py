"""Crash-safe checkpoint directories with validated manifests (the port
of ``mxnet_tpu/resilience/checkpoint.py``: the same layouts, formats and
metrics, so either package reads the other's checkpoints).

Layout (one run directory, many checkpoints)::

    run_dir/
      ckpt-0000000042/
        data.params        # NDArray container (atomic, per-array CRC32)
        trainer.pkl        # optional opaque trainer blob (atomic)
        MANIFEST.json      # written LAST, atomically — commit record
      ckpt-0000000084/...
      LATEST               # name of the newest committed checkpoint

The manifest is the commit point: a checkpoint directory without a
valid manifest (or whose files fail their CRC/size check) simply does
not exist as far as readers are concerned. Because every file lands via
``atomic_write`` and the manifest is written after the data it
describes, a crash at ANY byte of the save leaves the previous
checkpoint fully readable — :func:`latest_checkpoint` scans newest
first and silently skips partial/corrupt directories.

Manifest schema (``mxtpu-ckpt-v1``)::

    {"format": "mxtpu-ckpt-v1", "step": 42, "epoch": 3,
     "wall_time": 1722675300.1,
     "files":  {"data.params": {"crc32": ..., "nbytes": ...}, ...},
     "arrays": {"w": {"crc32":..., "nbytes":..., "shape": [..],
                      "dtype": "float32"}, ...},
     "extra":  {...}}           # trainer-specific (rng, scaler, ...)

Sharded checkpoints (``mxtpu-ckpt-v2``, :mod:`.sharded`) replace the
single ``data.params`` with N parallel-written ``shard-K-of-N.params``
files plus a ``layout`` manifest section recording each array's global
shape and per-shard row ranges — the commit/validity rules are
identical (a checkpoint exists iff its manifest commits and every
listed file passes size/CRC), and restore is *elastic*: the layout lets
a reader at any other world size assemble its own shards. Async saves
(:mod:`.async_writer`, ``CheckpointManager(async_=...)`` or
``MXNET_TPU_CKPT_ASYNC=1``) snapshot to host at the step boundary and
run everything from serialization to pruning on a background writer.

Checkpoint I/O is wrapped in bounded :mod:`.retry` so transient
``OSError`` (NFS blips, scripted test faults) are survived; an injected
crash is a ``BaseException`` and is never retried — a kill stays a kill.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

from . import faults
from . import sharded as _sharded
from .atomic import atomic_write, crc32_file, is_temp_path
from .retry import call_with_retry

__all__ = ["MANIFEST_NAME", "DATA_FILE", "TRAINER_FILE", "LATEST_NAME",
           "CKPT_PREFIX", "FORMAT", "FORMAT_SHARDED", "checkpoint_dirname",
           "sharded_mode", "async_mode", "snapshot_arrays",
           "write_checkpoint", "validate_checkpoint", "list_checkpoints",
           "latest_checkpoint", "read_arrays", "read_blob",
           "prune_checkpoints", "inflight_dirs", "CheckpointManager"]

MANIFEST_NAME = "MANIFEST.json"
DATA_FILE = "data.params"
TRAINER_FILE = "trainer.pkl"
LATEST_NAME = "LATEST"
CKPT_PREFIX = "ckpt-"
FORMAT = "mxtpu-ckpt-v1"
FORMAT_SHARDED = "mxtpu-ckpt-v2"

_RETRY = dict(retry_on=(OSError,), max_attempts=4, base_delay=0.02,
              max_delay=0.5)

# Checkpoint IO runs ms (tiny test nets) to minutes (sharded LLM state).
_CKPT_SECONDS_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                         0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                         120.0, 300.0)


def _obs():
    """Checkpoint metrics on the shared registry (created lazily so
    importing resilience never drags observability setup in)."""
    from ..observability import get_registry
    reg = get_registry()
    return {
        "write_secs": reg.histogram(
            "mxtpu_resilience_checkpoint_write_seconds",
            "Wall time of one committed checkpoint write (data + "
            "manifest + LATEST pointer).", buckets=_CKPT_SECONDS_BUCKETS),
        "writes": reg.counter(
            "mxtpu_resilience_checkpoint_writes_total",
            "Checkpoints committed by this process."),
        "write_bytes": reg.counter(
            "mxtpu_resilience_checkpoint_bytes_written_total",
            "Bytes committed across all checkpoint files."),
        "last_step": reg.gauge(
            "mxtpu_resilience_checkpoint_last_step",
            "Step of the most recently committed checkpoint."),
        "restore_secs": reg.histogram(
            "mxtpu_resilience_checkpoint_restore_seconds",
            "Wall time of one checkpoint array read (validated).",
            buckets=_CKPT_SECONDS_BUCKETS),
        "restores": reg.counter(
            "mxtpu_resilience_checkpoint_restores_total",
            "Checkpoint array reads completed."),
        "read_bytes": reg.counter(
            "mxtpu_resilience_checkpoint_bytes_read_total",
            "Bytes read back from checkpoint data files."),
        "corrupt": reg.counter(
            "mxtpu_resilience_checkpoint_corrupt_total",
            "Checkpoint directories skipped as partial/corrupt during "
            "newest-valid scans."),
        "pruned": reg.counter(
            "mxtpu_ckpt_pruned_total",
            "Checkpoint directories deleted by retention pruning, by "
            "reason (retention = superseded valid checkpoint, invalid = "
            "unreadable partial left by a crashed writer).", ("reason",)),
        "prune_skipped": reg.counter(
            "mxtpu_ckpt_prune_skipped_total",
            "Checkpoint directories a prune pass deliberately left "
            "alone, by reason (in_flight = an async save is still "
            "writing it — deleting it would corrupt the save).",
            ("reason",)),
    }


def _tracer():
    from ..observability.tracing import get_tracer
    return get_tracer()


def _corrupt(msg):
    from ..error import CheckpointCorruptError
    return CheckpointCorruptError(msg)


def checkpoint_dirname(step: int) -> str:
    return f"{CKPT_PREFIX}{int(step):010d}"


def _step_of(dirname: str):
    try:
        return int(dirname[len(CKPT_PREFIX):])
    except (ValueError, IndexError):
        return None


# ----------------------------------------------------------- env modes ----

def sharded_mode(override=None):
    """Resolve the shard count: ``None`` = legacy single-file v1 layout,
    else the number of shard files to write (v2). ``override`` (the
    ``num_shards=`` argument) wins over ``MXNET_TPU_CKPT_SHARDED``:
    ``0``/``off`` = v1, ``auto``/``on`` = one shard per participating
    process, an integer = exactly that many shards (``1`` still writes
    the v2 layout — useful for format-forward runs)."""
    if override is not None and not isinstance(override, str):
        if override is False or override == 0:
            return None
        if override is True:
            return _auto_shards()
        return max(1, int(override))
    if override is not None:
        v = override.strip().lower()
    else:
        v = os.environ.get("MXNET_TPU_CKPT_SHARDED", "").strip().lower()
    if v in ("", "0", "off", "false", "none"):
        return None
    if v in ("auto", "on", "true"):
        return _auto_shards()
    try:
        return max(1, int(v))
    except ValueError:
        raise ValueError(
            f"MXNET_TPU_CKPT_SHARDED/num_shards: expected an integer, "
            f"'auto'/'on', or '0'/'off', got {v!r}") from None


def _dist():
    """``torch.distributed`` when a process group exists, else None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def _auto_shards():
    dist = _dist()
    return 1 if dist is None else max(1, dist.get_world_size())


def async_mode(override=None) -> bool:
    """``MXNET_TPU_CKPT_ASYNC`` truthy = background writer saves."""
    if override is not None:
        return bool(override)
    return os.environ.get("MXNET_TPU_CKPT_ASYNC", "").strip().lower() \
        in ("1", "on", "true", "auto")


def snapshot_arrays(arrays):
    """Host copies of an array tree — the consistent step-boundary
    snapshot an async save hands to the writer thread. The device→host
    copies are blocking and finish before this returns (the fused
    update kernel overwrites weights and optimizer slots in place on the
    very next step), and host inputs are copied too, so later in-place
    mutation of the live parameters cannot leak into the write. Tensors
    come back as CPU tensors, anything else as numpy arrays."""
    import numpy as _np
    import torch
    out = {}
    for name, a in arrays.items():
        if isinstance(a, torch.Tensor):
            out[name] = a.detach().to("cpu", copy=True)
        else:
            out[name] = _np.array(a, copy=True)
    return out


# ------------------------------------------------- in-flight protection ----

_INFLIGHT_LOCK = threading.Lock()
_INFLIGHT = {}   # realpath(run_dir) -> set of ckpt dir basenames


@contextlib.contextmanager
def _mark_inflight(run_dir, dirname):
    """Register a checkpoint directory as being written so concurrent
    prune passes (sync callers racing an async writer) neither delete
    its half-written files as "invalid" nor count it toward retention
    before its manifest commits."""
    key = os.path.realpath(run_dir)
    with _INFLIGHT_LOCK:
        _INFLIGHT.setdefault(key, set()).add(dirname)
    try:
        yield
    finally:
        with _INFLIGHT_LOCK:
            members = _INFLIGHT.get(key)
            if members is not None:
                members.discard(dirname)
                if not members:
                    _INFLIGHT.pop(key, None)


def inflight_dirs(run_dir):
    """Basenames of checkpoint dirs currently being written under
    ``run_dir`` (this process)."""
    with _INFLIGHT_LOCK:
        return set(_INFLIGHT.get(os.path.realpath(run_dir), ()))


# ---------------------------------------------------------------- write ----

def write_checkpoint(run_dir, arrays, step, epoch=None, extra=None,
                     blobs=None, keep=None, num_shards=None):
    """Commit one checkpoint under ``run_dir``; returns its path.

    arrays : dict name -> tensor (any device) or host numpy (saved into
             ``data.params``, or ``shard-K-of-N.params`` files when
             sharded)
    blobs  : optional dict filename -> bytes (opaque sidecar files,
             e.g. pickled optimizer state), each written atomically and
             CRC-recorded in the manifest
    extra  : JSON-serializable trainer metadata stored verbatim
    keep   : if set, prune to the newest ``keep`` valid checkpoints
             (after the commit — never before)
    num_shards : shard-count override for :func:`sharded_mode`; the
             resolved count > 0 writes the ``mxtpu-ckpt-v2`` layout with
             parallel per-shard files (:mod:`.sharded`)

    In multi-process runs only process 0 writes (checkpoints hold
    replicated/global state; N identical writers would race on the same
    files); other ranks return ``None``.
    """
    if _process_index() != 0:
        return None
    shards = sharded_mode(num_shards)
    obs = _obs()
    t0 = time.monotonic()
    os.makedirs(run_dir, exist_ok=True)
    ckpt = os.path.join(run_dir, checkpoint_dirname(step))
    with _tracer().span("mxtpu.ckpt.write", "resilience") as span, \
            _mark_inflight(run_dir, os.path.basename(ckpt)):
        span.set("step", int(step))
        if shards:
            span.set("shards", int(shards))
        os.makedirs(ckpt, exist_ok=True)

        def _write_all():
            faults.check("checkpoint.write")
            files = {}
            if shards:
                meta = _sharded.global_array_meta(arrays)
                layout = _sharded.plan_layout(meta, shards)
                per_shard = _sharded.partition_arrays(arrays, layout,
                                                      shards)
                files.update(_sharded.write_shard_files(ckpt, per_shard,
                                                        shards))
                arrays_meta = {
                    name: {"shape": list(shape), "dtype": dtype}
                    for name, (shape, dtype) in meta.items()}
            else:
                from ..ndarray import save as nd_save
                meta = nd_save(os.path.join(ckpt, DATA_FILE),
                               dict(arrays))
                files[DATA_FILE] = {"crc32": meta["crc32"],
                                    "nbytes": meta["nbytes"]}
                arrays_meta = meta["arrays"]
            for fname, payload in (blobs or {}).items():
                with atomic_write(os.path.join(ckpt, fname)) as f:
                    f.write(payload)
                files[fname] = {"crc32": f.crc32, "nbytes": f.nbytes}
            manifest = {"format": FORMAT_SHARDED if shards else FORMAT,
                        "step": int(step),
                        "epoch": None if epoch is None else int(epoch),
                        "wall_time": time.time(), "files": files,
                        "arrays": arrays_meta, "extra": extra or {}}
            if shards:
                manifest["layout"] = {"num_shards": int(shards),
                                      "arrays": layout}
            # the manifest write is the commit: everything above is
            # invisible to readers until this rename lands
            faults.point("ckpt.manifest")
            with atomic_write(os.path.join(ckpt, MANIFEST_NAME)) as f:
                f.write(json.dumps(manifest, indent=1).encode())
            return manifest

        manifest = call_with_retry(_write_all, op="checkpoint.write",
                                   **_RETRY)
        faults.point("ckpt.latest")
        with atomic_write(os.path.join(run_dir, LATEST_NAME)) as f:
            f.write(os.path.basename(ckpt).encode())
        nbytes = sum(int(rec["nbytes"]) for rec in
                     manifest.get("files", {}).values())
        span.set("bytes", nbytes)
        obs["write_secs"].observe(time.monotonic() - t0)
        obs["writes"].inc()
        obs["write_bytes"].inc(nbytes)
        obs["last_step"].set(int(step))
    # retention runs strictly AFTER the commit (and after this dir left
    # the in-flight set), so a crash during prune can only ever remove
    # superseded state — the just-committed checkpoint is already safe
    if keep is not None:
        prune_checkpoints(run_dir, keep)
    return ckpt


def _process_index():
    """This process's rank in the ``torch.distributed`` process group,
    0 without one."""
    dist = _dist()
    return 0 if dist is None else dist.get_rank()


# ----------------------------------------------------------------- read ----

def validate_checkpoint(ckpt_dir):
    """Return the manifest of a committed, intact checkpoint; raise
    :class:`~mxnet_tpu_torch.error.CheckpointCorruptError` otherwise (missing
    or unparsable manifest, missing files, size/CRC mismatch)."""
    mpath = os.path.join(ckpt_dir, MANIFEST_NAME)
    if not os.path.isfile(mpath):
        raise _corrupt(f"{ckpt_dir}: no {MANIFEST_NAME} — checkpoint was "
                       "never committed (partial write?)")
    try:
        with open(mpath, "rb") as f:
            manifest = json.loads(f.read().decode())
    except (OSError, ValueError, UnicodeDecodeError) as exc:
        raise _corrupt(f"{mpath}: unreadable manifest: {exc!r}") from exc
    if manifest.get("format") not in (FORMAT, FORMAT_SHARDED):
        raise _corrupt(f"{mpath}: unknown format "
                       f"{manifest.get('format')!r}")
    for fname, want in manifest.get("files", {}).items():
        path = os.path.join(ckpt_dir, fname)
        if not os.path.isfile(path):
            raise _corrupt(f"{ckpt_dir}: missing file {fname}")
        crc, n = crc32_file(path)
        if n != int(want["nbytes"]) or crc != int(want["crc32"]):
            raise _corrupt(
                f"{path}: size/CRC mismatch (got {n}B crc {crc}, "
                f"manifest says {want['nbytes']}B crc {want['crc32']})")
    return manifest


def list_checkpoints(run_dir):
    """All checkpoint dirs under ``run_dir`` as ``[(step, path)]``,
    newest first, committed or not (use :func:`validate_checkpoint` to
    filter). Temp strays are skipped."""
    out = []
    try:
        entries = os.listdir(run_dir)
    except OSError:
        return out
    for name in entries:
        if is_temp_path(name) or not name.startswith(CKPT_PREFIX):
            continue
        step = _step_of(name)
        path = os.path.join(run_dir, name)
        if step is not None and os.path.isdir(path):
            out.append((step, path))
    out.sort(reverse=True)
    return out


def latest_checkpoint(run_dir):
    """Newest checkpoint that validates, as ``(path, manifest)``;
    ``(None, None)`` if none. The newest-first scan is authoritative —
    the ``LATEST`` pointer can be one save stale (writer killed between
    the manifest commit and the pointer update) and is only consulted as
    a last-resort fallback for non-``ckpt-*`` directory names. An async
    save in flight for ``run_dir`` is joined first, so within one
    process a reader never races its own background commit."""
    from ..error import CheckpointCorruptError
    from .async_writer import join_run_dir
    join_run_dir(run_dir)
    for _, path in list_checkpoints(run_dir):
        try:
            return path, validate_checkpoint(path)
        except CheckpointCorruptError:
            _obs()["corrupt"].inc()
            continue
    latest = os.path.join(run_dir, LATEST_NAME)
    if os.path.isfile(latest):
        try:
            with open(latest) as f:
                cand = os.path.join(run_dir, f.read().strip())
            return cand, validate_checkpoint(cand)
        except (OSError, CheckpointCorruptError):
            pass
    return None, None


def read_arrays(ckpt_dir, manifest=None, verify_arrays=False):
    """Load ``data.params`` from a checkpoint.

    When ``manifest`` comes from a just-run :func:`validate_checkpoint`
    (the usual restore path), its whole-file CRC already covered every
    byte of ``data.params``, so the per-array re-check is skipped by
    default — restoring a large model reads the file once, not twice.
    Pass ``verify_arrays=True`` to re-check each array anyway (e.g. when
    the validation happened long before the read)."""
    if manifest is None:
        manifest = validate_checkpoint(ckpt_dir)
    obs = _obs()
    t0 = time.monotonic()
    with _tracer().span("mxtpu.ckpt.restore", "resilience") as span:
        span.set("step", manifest.get("step"))
        if manifest.get("format") == FORMAT_SHARDED:
            out = _sharded.read_sharded_arrays(ckpt_dir, manifest,
                                               verify=verify_arrays)
            nbytes = sum(
                int(rec["nbytes"])
                for fname, rec in manifest.get("files", {}).items()
                if _sharded.parse_shard_filename(fname))
            span.set("bytes", nbytes)
            obs["read_bytes"].inc(nbytes)
        else:
            from ..ndarray import load_tensors as nd_load
            out = nd_load(os.path.join(ckpt_dir, DATA_FILE),
                          manifest=manifest.get("arrays") if verify_arrays
                          else None)
            data_rec = manifest.get("files", {}).get(DATA_FILE)
            if data_rec:
                span.set("bytes", int(data_rec["nbytes"]))
                obs["read_bytes"].inc(int(data_rec["nbytes"]))
    obs["restore_secs"].observe(time.monotonic() - t0)
    obs["restores"].inc()
    return out


def read_blob(ckpt_dir, fname, manifest=None):
    """Read a sidecar blob, CRC-checked against the manifest."""
    if manifest is None:
        manifest = validate_checkpoint(ckpt_dir)
    want = manifest.get("files", {}).get(fname)
    path = os.path.join(ckpt_dir, fname)
    with open(path, "rb") as f:
        payload = f.read()
    if want is not None:
        import zlib
        if len(payload) != int(want["nbytes"]) or \
                zlib.crc32(payload) != int(want["crc32"]):
            raise _corrupt(f"{path}: blob CRC mismatch")
    return payload


def prune_checkpoints(run_dir, keep: int):
    """Delete all but the newest ``keep`` VALID checkpoints. Invalid /
    partial directories are removed too (unreadable noise a crashed
    writer left behind) — EXCEPT directories an in-flight save of this
    process is still writing: those look partial right up to their
    manifest commit, and deleting one would corrupt the save that is
    about to supersede everything. Skips and deletions are counted on
    ``mxtpu_ckpt_prune*`` metrics."""
    from ..error import CheckpointCorruptError
    import shutil
    obs = _obs()
    faults.point("ckpt.prune")
    protected = inflight_dirs(run_dir)
    valid = []
    for step, path in list_checkpoints(run_dir):
        if os.path.basename(path) in protected:
            obs["prune_skipped"].labels(reason="in_flight").inc()
            continue
        try:
            validate_checkpoint(path)
            valid.append(path)
        except CheckpointCorruptError:
            shutil.rmtree(path, ignore_errors=True)
            obs["pruned"].labels(reason="invalid").inc()
    for path in valid[keep:]:
        shutil.rmtree(path, ignore_errors=True)
        obs["pruned"].labels(reason="retention").inc()


def manager_for(cache, run_dir, keep=5, num_shards=None):
    """Per-run-dir :class:`CheckpointManager` out of a caller-owned
    cache dict (the trainers keep one), refreshed with the caller's
    current retention/shard settings."""
    key = os.path.realpath(os.fspath(run_dir))
    mgr = cache.get(key)
    if mgr is None:
        mgr = cache[key] = CheckpointManager(run_dir, keep=keep,
                                             num_shards=num_shards)
    mgr.keep = keep
    mgr._num_shards = num_shards
    return mgr


class CheckpointManager:
    """Convenience wrapper binding a run directory + retention policy,
    with the sharded/async levers.

    >>> mgr = CheckpointManager(run_dir, keep=3)
    >>> mgr.save(arrays, step=10, extra={"rng": ...})
    >>> path, manifest = mgr.latest()
    >>> arrays = mgr.load_arrays(path, manifest)

    ``async_``/``num_shards`` default to the ``MXNET_TPU_CKPT_ASYNC`` /
    ``MXNET_TPU_CKPT_SHARDED`` environment (re-read per save, so tests
    and long-lived trainers pick up changes). Async saves snapshot the
    arrays to host immediately and return an
    :class:`~.async_writer.AsyncSaveHandle` (truthy; ``result()`` joins);
    sync saves return the committed path. ``wait``/``flush``/``close``
    join the background writer and surface any parked write error as
    :class:`~mxnet_tpu_torch.error.CheckpointWriteError`.
    """

    def __init__(self, run_dir, keep=5, async_=None, num_shards=None):
        self.run_dir = os.fspath(run_dir)
        self.keep = keep
        self._async = async_
        self._num_shards = num_shards

    def save(self, arrays, step, epoch=None, extra=None, blobs=None):
        if not async_mode(self._async):
            return write_checkpoint(self.run_dir, arrays, step,
                                    epoch=epoch, extra=extra, blobs=blobs,
                                    keep=self.keep,
                                    num_shards=self._num_shards)
        if _process_index() != 0:
            return None
        from .async_writer import _obs as _aw_obs, writer_for
        t0 = time.monotonic()
        host = snapshot_arrays(arrays)
        _aw_obs()["snapshot_secs"].observe(time.monotonic() - t0)
        run_dir, keep, num_shards = self.run_dir, self.keep, \
            self._num_shards
        step_i = int(step)

        def job():
            return write_checkpoint(run_dir, host, step_i, epoch=epoch,
                                    extra=extra, blobs=blobs, keep=keep,
                                    num_shards=num_shards)

        return writer_for(run_dir).submit(
            job, path=os.path.join(run_dir, checkpoint_dirname(step_i)),
            step=step_i)

    # ------------------------------------------------------ writer sync --
    @property
    def in_flight(self) -> bool:
        from .async_writer import peek_writer
        w = peek_writer(self.run_dir)
        return w is not None and w.in_flight

    def wait(self, timeout=None):
        """Join any in-flight async save; raises the typed error of a
        failed one. No-op for sync-only managers."""
        from .async_writer import peek_writer
        w = peek_writer(self.run_dir)
        return w.wait(timeout) if w is not None else None

    flush = wait

    def close(self):
        self.wait()

    def latest(self):
        return latest_checkpoint(self.run_dir)

    def load_arrays(self, ckpt_dir=None, manifest=None):
        if ckpt_dir is None:
            ckpt_dir, manifest = self.latest()
            if ckpt_dir is None:
                raise _corrupt(
                    f"{self.run_dir}: no restorable checkpoint found")
        return read_arrays(ckpt_dir, manifest)

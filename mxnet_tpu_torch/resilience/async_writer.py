"""Async checkpoint writes: snapshot at the step boundary, serialize in
the background (the port of ``mxnet_tpu/resilience/async_writer.py``).

A synchronous checkpoint stalls training for the full serialize+fsync
wall time. The only part that must happen at a step boundary is the
device→host *snapshot* (params/optimizer/RNG are consistent there and
the copy is cheap next to the write; ``checkpoint.snapshot_arrays``
finishes its blocking copies before it returns, so the fused update
kernel writing the same tensors in place on the next step cannot reach
the bytes on disk); everything after — container
serialization, CRC, fsync, manifest commit, retention pruning — runs on
one daemon writer thread per run directory while training keeps
stepping.

Discipline (all deterministic, no timers):

- **At most one save in flight** per writer. A second ``submit`` while
  one is running *joins* the previous save first (backpressure — the
  wait is metered on ``mxtpu_ckpt_async_backpressure_seconds``, so a
  checkpoint cadence outrunning the disk is visible, not silent).
- **No silent loss.** A failed background write parks its exception and
  re-raises it — typed, as :class:`~mxnet_tpu.error.CheckpointWriteError`
  — on the NEXT ``submit``/``wait``/``close``. The newest previously
  committed checkpoint is untouched (a partial directory never
  validates).
- **Readers never race.** ``checkpoint.latest_checkpoint`` joins the
  run directory's writer before scanning, so an in-flight commit is
  either fully visible or not started — within one process a reader
  cannot observe the torn middle.
- At interpreter exit every writer is flushed (``atexit``), so the last
  checkpoint of a run is never abandoned half-written on clean exits.

``mxtpu_ckpt_async_*`` metrics (submitted/committed/errors counters,
in-flight gauge, backpressure/write-seconds histograms, plus the
``overlap_steps`` counter the trainers feed) prove the overlap: steps
land while ``in_flight`` is 1.
"""
from __future__ import annotations

import atexit
import os
import threading
import time

__all__ = ["AsyncSaveHandle", "AsyncCheckpointWriter", "writer_for",
           "peek_writer", "join_run_dir", "wait_all", "note_step_overlap",
           "any_in_flight"]

_ASYNC_SECONDS_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                          0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                          120.0, 300.0)

_OBS = None


def _obs():
    global _OBS
    if _OBS is None:
        from ..observability import get_registry
        reg = get_registry()
        _OBS = {
            "submitted": reg.counter(
                "mxtpu_ckpt_async_submitted_total",
                "Async checkpoint saves handed to a background writer."),
            "committed": reg.counter(
                "mxtpu_ckpt_async_committed_total",
                "Async checkpoint saves whose manifest committed."),
            "errors": reg.counter(
                "mxtpu_ckpt_async_errors_total",
                "Async checkpoint saves that failed in the writer thread "
                "(surfaced as CheckpointWriteError on the next "
                "save/wait/close)."),
            "in_flight": reg.gauge(
                "mxtpu_ckpt_async_in_flight",
                "Background checkpoint writes currently running, summed "
                "across run-dir writers (each writer holds at most one "
                "save in flight)."),
            "backpressure": reg.histogram(
                "mxtpu_ckpt_async_backpressure_seconds",
                "Time submit() blocked joining the previous in-flight "
                "save — nonzero means the save cadence outruns the "
                "writer.", buckets=_ASYNC_SECONDS_BUCKETS),
            "write_secs": reg.histogram(
                "mxtpu_ckpt_async_write_seconds",
                "Background serialize+fsync+commit time of one async "
                "save (off the training critical path).",
                buckets=_ASYNC_SECONDS_BUCKETS),
            "snapshot_secs": reg.histogram(
                "mxtpu_ckpt_async_snapshot_seconds",
                "Device-to-host snapshot time paid at the step boundary "
                "before handing off to the writer (the only synchronous "
                "part of an async save).", buckets=_ASYNC_SECONDS_BUCKETS),
            "overlap_steps": reg.counter(
                "mxtpu_ckpt_async_overlap_steps_total",
                "Training steps completed while an async checkpoint "
                "write was in flight — direct evidence the save is off "
                "the critical path."),
        }
    return _OBS


def _tracer():
    from ..observability.tracing import get_tracer
    return get_tracer()


# process-wide in-flight count: the gauge is one unlabeled series, so
# concurrent writers for different run dirs must sum, not clobber —
# and the gauge publish happens under the same lock so two writers
# finishing/starting concurrently cannot land their sets out of order
_IN_FLIGHT = 0
_IN_FLIGHT_LOCK = threading.Lock()


def _in_flight_update(delta, gauge):
    global _IN_FLIGHT
    with _IN_FLIGHT_LOCK:
        _IN_FLIGHT = max(0, _IN_FLIGHT + delta)
        gauge.set(_IN_FLIGHT)


class AsyncSaveHandle:
    """Future-ish handle for one submitted save. Truthy (so
    ``assert trainer.save_state(dir)`` keeps meaning "a save will
    commit"); ``result()`` joins and returns the checkpoint path or
    re-raises the writer's failure."""

    def __init__(self, path, step):
        self.path = path
        self.step = step
        self._done = threading.Event()
        self._exc = None
        self._result = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"async checkpoint save (step {self.step}) still running")
        if self._exc is not None:
            raise self._exc
        return self._result

    def __fspath__(self):
        return self.path

    def __repr__(self):
        state = "done" if self.done() else "in-flight"
        return f"<AsyncSaveHandle step={self.step} {state} {self.path!r}>"


class AsyncCheckpointWriter:
    """One background writer; at most one save in flight."""

    def __init__(self, name="ckpt"):
        self.name = name
        self._lock = threading.Lock()
        self._submit_lock = threading.Lock()   # serializes submit()
        self._thread = None
        self._handle = None
        self._pending_exc = None

    # ------------------------------------------------------------ state --
    @property
    def in_flight(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def join(self, timeout=None):
        """Wait for the in-flight save WITHOUT surfacing errors (reader
        sync; errors still park for the next save/wait/close)."""
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout)

    def _raise_pending(self):
        with self._lock:
            exc, self._pending_exc = self._pending_exc, None
        if exc is None:
            return
        if not isinstance(exc, Exception):
            raise exc   # InjectedCrash & co: a kill stays a kill
        from ..error import CheckpointWriteError
        raise CheckpointWriteError(
            f"previous async checkpoint save ({self.name}) failed: "
            f"{exc!r}") from exc

    # ----------------------------------------------------------- submit --
    def submit(self, fn, path=None, step=None):
        """Run ``fn()`` (the serialize+commit closure) on the writer
        thread. Surfaces any parked failure first, then joins the
        previous save (backpressure), then starts this one. Returns an
        :class:`AsyncSaveHandle` immediately. Concurrent submitters
        (e.g. a preemption callback racing the training thread) are
        serialized — at most one in-flight save is an invariant, not a
        fast-path assumption."""
        with self._submit_lock:
            obs = _obs()
            self._raise_pending()
            t0 = time.monotonic()
            self.join()
            obs["backpressure"].observe(time.monotonic() - t0)
            self._raise_pending()   # the save just joined may have failed
            handle = AsyncSaveHandle(path, step)
            parent = _tracer().current()

            def run():
                t0w = time.monotonic()
                try:
                    with _tracer().span("mxtpu.ckpt.async.write",
                                        "resilience", parent) as sp:
                        sp.set("step", step)
                        handle._result = fn()
                    obs["committed"].inc()
                except BaseException as exc:   # noqa: B036 — InjectedCrash
                    handle._exc = exc
                    with self._lock:
                        self._pending_exc = exc
                    obs["errors"].inc()
                finally:
                    obs["write_secs"].observe(time.monotonic() - t0w)
                    _in_flight_update(-1, obs["in_flight"])
                    handle._done.set()

            obs["submitted"].inc()
            _in_flight_update(+1, obs["in_flight"])
            t = threading.Thread(target=run, daemon=True,
                                 name=f"mxtpu-ckpt-writer-{self.name}")
            # start BEFORE publishing: a concurrent join()/wait() that
            # grabs self._thread must never call Thread.join on an
            # unstarted thread (RuntimeError)
            t.start()
            self._thread, self._handle = t, handle
            return handle

    # ------------------------------------------------------------- wait --
    def wait(self, timeout=None):
        """Join the in-flight save and surface its error (typed) if it
        failed. Raises ``TimeoutError`` if the save is still running
        when ``timeout`` expires — a wait() that returns means the save
        is durable (or its failure was raised), never "still writing".
        Returns the last handle (or None)."""
        self.join(timeout)
        if self.in_flight:
            raise TimeoutError(
                f"async checkpoint save ({self.name}) still running "
                f"after {timeout}s")
        self._raise_pending()
        return self._handle

    flush = wait

    def close(self):
        """Final flush — the "no silent loss" boundary on shutdown."""
        self.wait()


# -------------------------------------------------- per-run-dir registry --

_WRITERS = {}
_WRITERS_LOCK = threading.Lock()
_ATEXIT_INSTALLED = False


def _key(run_dir):
    return os.path.realpath(os.fspath(run_dir))


def writer_for(run_dir) -> AsyncCheckpointWriter:
    """The (lazily created) writer owning ``run_dir``. One writer per
    directory serializes saves to the same run; different runs overlap
    freely."""
    global _ATEXIT_INSTALLED
    key = _key(run_dir)
    with _WRITERS_LOCK:
        w = _WRITERS.get(key)
        if w is None:
            w = _WRITERS[key] = AsyncCheckpointWriter(
                name=os.path.basename(key) or key)
        if not _ATEXIT_INSTALLED:
            _ATEXIT_INSTALLED = True
            atexit.register(_flush_at_exit)
    return w


def peek_writer(run_dir):
    """The writer for ``run_dir`` if one exists (never creates)."""
    with _WRITERS_LOCK:
        return _WRITERS.get(_key(run_dir))


def join_run_dir(run_dir):
    """Reader-side sync: block until ``run_dir`` has no save in flight.
    Errors stay parked for the writer's next save/wait/close."""
    w = peek_writer(run_dir)
    if w is not None:
        w.join()


def wait_all():
    """Flush every writer; raises the FIRST parked failure (after all
    writers drained)."""
    with _WRITERS_LOCK:
        writers = list(_WRITERS.values())
    first = None
    for w in writers:
        try:
            w.wait()
        except BaseException as exc:   # noqa: B036
            if first is None:
                first = exc
    if first is not None:
        raise first


def _flush_at_exit():
    try:
        wait_all()
    except BaseException as exc:   # noqa: B036 — report, don't mask exit
        import warnings
        warnings.warn(f"async checkpoint flush at exit failed: {exc!r}")


def _reset_for_tests():
    """Join and forget every writer, dropping parked errors (test
    teardown only)."""
    with _WRITERS_LOCK:
        writers = list(_WRITERS.values())
        _WRITERS.clear()
    for w in writers:
        w.join()
        w._pending_exc = None


# --------------------------------------------------------- overlap hook --

def any_in_flight() -> bool:
    if not _WRITERS:
        return False
    with _WRITERS_LOCK:
        writers = list(_WRITERS.values())
    return any(w.in_flight for w in writers)


def note_step_overlap():
    """Called by the trainers once per completed step; counts the step
    as overlapped when any async save is in flight. Near-free when the
    feature is unused (one empty-dict check)."""
    if not _WRITERS:
        return
    if any_in_flight():
        _obs()["overlap_steps"].inc()

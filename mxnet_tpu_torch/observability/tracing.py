"""Process-wide span tracer: causal timelines over the metrics registry
(the port of ``mxnet_tpu/observability/tracing.py``).

The :class:`~.registry.MetricsRegistry` answers "how much / how often";
this module answers "and in what order, caused by what": nested host
spans with contextvar propagation that survives thread hops (the
serving worker thread), buffered in a bounded ring and exportable as
Chrome trace-event JSON that Perfetto / ``chrome://tracing`` open
directly: one step / one request can be read end to end.

Three integration rules keep the tracer honest:

- **off = free.** With tracing disabled, every ``tracer.span(...)``
  call on a hot path returns the same ``_NULL`` singleton — no object,
  dict or closure is allocated per step (the ``mxtpu_trace_*`` counters
  stay at 0). Call sites therefore never need their own ``if enabled``
  guards.
- **bounded memory.** Completed spans land in a ring of
  ``MXNET_TPU_TRACE_RING`` entries (drops counted on
  ``mxtpu_trace_spans_dropped_total``), so a week-long serving process
  with tracing on cannot leak.
- **one timeline with the device.** While a torch profiler records
  (``torch.profiler.profile``), every span opened on its own thread also
  opens a ``torch.profiler.record_function`` range of its name, so host
  spans such as ``mxtpu.llm.step`` sit beside the kernels they launched
  in the profiler's trace. The check is one C call
  (``torch.autograd._profiler_enabled``) made only where a span opens,
  and the tracer imports no torch: it reads the module only if the
  process has loaded it.

Cross-thread propagation is explicit: contextvars do not follow work
onto other threads, so producers capture ``tracer.current()`` at
hand-off and workers either pass it as ``parent=`` or wrap their work
in ``tracer.attach(parent)``.

Env vars: ``MXNET_TPU_TRACE`` (truthy enables at first use; a value
containing a path separator or ending in ``.json`` is also the at-exit
export path), ``MXNET_TPU_TRACE_RING`` (ring capacity, default 32768),
``MXNET_TPU_TRACE_DIR`` (directory for at-exit export,
``trace_<pid>.json``).
"""
from __future__ import annotations

import collections
import contextvars
import itertools
import json
import os
import sys
import threading
import time

__all__ = ["Span", "Tracer", "get_tracer", "trace_ring_capacity",
           "validate_chrome_trace"]

DEFAULT_RING = 32768

# The active span of the current execution context. Threads started
# before a span opened (or plain worker threads) see None and must be
# handed a parent explicitly (tracer.current() at submit time).
_CURRENT = contextvars.ContextVar("mxtpu_trace_span", default=None)

_ids = itertools.count(1)


def trace_ring_capacity():
    """Ring capacity: ``MXNET_TPU_TRACE_RING`` or the default."""
    try:
        n = int(os.environ.get("MXNET_TPU_TRACE_RING",
                               DEFAULT_RING) or DEFAULT_RING)
    except ValueError:
        return DEFAULT_RING
    return max(16, n)


def _profiler_running():
    """True while a torch profiler records. Reads torch from
    ``sys.modules`` so importing the tracer never imports it."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


def _profiler_range(name):
    """An entered ``torch.profiler.record_function`` range named
    ``name``: the span's mark on the profiler's timeline."""
    rng = sys.modules["torch"].profiler.record_function(name)
    rng.__enter__()
    return rng


class _NullSpan:
    """The shared no-op span. Context-manageable, settable, finishable —
    every method free of allocation, so disabled tracing costs a method
    call and nothing else on the hot path."""

    __slots__ = ()
    span_id = None
    name = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key, value):
        return self

    def finish(self):
        return None


_NULL = _NullSpan()


class _AnnSpan:
    """Span-shaped wrapper over a bare profiler range, returned when a
    profiler records but the tracer itself is off — call sites keep one
    API (``set`` is a no-op; only the profiler range is real)."""

    __slots__ = ("_rng",)
    span_id = None
    name = None

    def __init__(self, rng):
        self._rng = rng

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
        return False

    def set(self, key, value):
        return self

    def finish(self):
        if self._rng is not None:
            rng, self._rng = self._rng, None
            rng.__exit__(None, None, None)


class Span:
    """One host span: created open, recorded into the tracer's ring on
    :meth:`finish` (or context-manager exit).

    ``activate=True`` (the default for ``tracer.span``) installs the
    span as the current contextvar value for its dynamic extent, so
    spans opened underneath nest automatically. Hand-off spans
    (``tracer.begin``) stay un-activated: they are created on one
    thread and finished on another (a serving request), where a
    contextvar token could not be reset correctly.
    """

    __slots__ = ("_tracer", "name", "cat", "span_id", "parent_id",
                 "parent_tid", "tid", "thread_name", "t0_ns", "attrs",
                 "_token", "_rng", "_done")

    def __init__(self, tracer, name, cat, parent, attrs, step, activate):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.span_id = next(_ids)
        if parent is None and activate:
            parent = _CURRENT.get()
        if parent is not None and parent.span_id is not None:
            self.parent_id = parent.span_id
            self.parent_tid = parent.tid
        else:
            self.parent_id = None
            self.parent_tid = None
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.thread_name = t.name
        self.attrs = dict(attrs) if attrs else None
        if step is not None:
            self.set("step", int(step))
        self._token = _CURRENT.set(self) if activate else None
        # hand-off spans (activate=False) open on one thread and finish
        # on another; a profiler range is closed on the thread that
        # opened it, so only activated (same-thread) spans get one
        self._rng = None
        if activate and _profiler_running():
            self._rng = _profiler_range(name)
        self._done = False
        tracer._on_start()
        self.t0_ns = time.monotonic_ns()

    # ------------------------------------------------------------- api --
    def set(self, key, value):
        """Attach one attribute (rendered into the trace event args)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value
        return self

    def finish(self):
        if self._done:
            return
        dur_ns = time.monotonic_ns() - self.t0_ns
        self._done = True
        if self._rng is not None:
            rng, self._rng = self._rng, None
            rng.__exit__(None, None, None)
        if self._token is not None:
            try:
                _CURRENT.reset(self._token)
            except ValueError:
                # finished from a different context than it was opened
                # in (generator teardown); clearing beats leaking
                _CURRENT.set(None)
            self._token = None
        self._tracer._record(self, dur_ns)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
        return False


class Tracer:
    """Bounded process tracer. Use the module singleton
    (:func:`get_tracer`); fresh instances exist for tests."""

    def __init__(self, ring=None, registry=None):
        self._lock = threading.Lock()
        self._ring = collections.deque(
            maxlen=ring if ring else trace_ring_capacity())
        self._registry = registry
        self._enabled = False
        self._open = 0
        self._epoch_ns = time.monotonic_ns()
        self._obs = None

    # -------------------------------------------------------- lifecycle --
    @property
    def enabled(self):
        return self._enabled

    def enable(self, ring=None):
        """Turn span recording on (idempotent); ``ring`` resizes the
        buffer, dropping whatever an old smaller ring held."""
        with self._lock:
            if ring and ring != self._ring.maxlen:
                self._ring = collections.deque(self._ring, maxlen=ring)
            self._enabled = True
            self._metrics()
        return self

    def disable(self):
        self._enabled = False
        return self

    def clear(self):
        with self._lock:
            self._ring.clear()

    def _metrics(self):
        if self._obs is None:
            if self._registry is None:
                from .registry import get_registry
                self._registry = get_registry()
            reg = self._registry
            self._obs = {
                "started": reg.counter(
                    "mxtpu_trace_spans_started_total",
                    "Tracer spans opened (0 while tracing is off — the "
                    "zero-overhead contract)."),
                "dropped": reg.counter(
                    "mxtpu_trace_spans_dropped_total",
                    "Completed spans evicted from the bounded ring "
                    "before an export read them."),
                "exports": reg.counter(
                    "mxtpu_trace_exports_total",
                    "Chrome-trace exports written."),
                "export_bytes": reg.counter(
                    "mxtpu_trace_export_bytes_total",
                    "Bytes of Chrome-trace JSON written by exports."),
            }
        return self._obs

    # ------------------------------------------------------------ spans --
    def span(self, name, cat="host", parent=None, attrs=None, step=None):
        """Open a nested, context-activated span. Returns the ``_NULL``
        singleton when tracing is off (and no profiler capture is
        running), so hot paths call this unconditionally."""
        if not self._enabled:
            if _profiler_running():
                return _AnnSpan(_profiler_range(name))
            return _NULL
        return Span(self, name, cat, parent, attrs, step, True)

    def begin(self, name, cat="host", parent=None, attrs=None):
        """Open a hand-off span: NOT installed as the current context
        (it will be finished on another thread — serving requests,
        background writers). Pair with ``span.finish()``."""
        if not self._enabled:
            return _NULL
        return Span(self, name, cat, parent, attrs, None, False)

    def current(self):
        """The active span of this execution context (None outside any
        span, or on a thread no span was propagated to)."""
        return _CURRENT.get()

    def attach(self, parent):
        """Context manager adopting ``parent`` as this thread's current
        span — the explicit cross-thread propagation primitive::

            parent = tracer.current()        # producer side
            ...
            with tracer.attach(parent):      # worker thread
                with tracer.span("work"):    # nests under parent
        """
        return _Attach(parent)

    # --------------------------------------------------------- recording --
    def _on_start(self):
        with self._lock:
            self._open += 1
        self._metrics()["started"].inc()

    def _record(self, span, dur_ns):
        rec = (span.name, span.cat,
               (span.t0_ns - self._epoch_ns) // 1000, dur_ns // 1000,
               span.tid, span.thread_name, span.span_id, span.parent_id,
               span.parent_tid, span.attrs)
        with self._lock:
            self._open -= 1
            if len(self._ring) == self._ring.maxlen:
                self._metrics()["dropped"].inc()
            self._ring.append(rec)

    # ------------------------------------------------------- introspection --
    def stats(self):
        with self._lock:
            obs = self._metrics()
            return {"enabled": self._enabled,
                    "buffered": len(self._ring),
                    "capacity": self._ring.maxlen,
                    "open": self._open,
                    "started": int(obs["started"].value),
                    "dropped": int(obs["dropped"].value)}

    def snapshot(self):
        """Completed spans currently buffered, oldest first, as dicts
        (test/debug surface; export() is the production path)."""
        with self._lock:
            ring = list(self._ring)
        return [{"name": n, "cat": c, "ts_us": ts, "dur_us": dur,
                 "tid": tid, "thread": tname, "span_id": sid,
                 "parent_id": pid, "parent_tid": ptid,
                 "attrs": attrs or {}}
                for (n, c, ts, dur, tid, tname, sid, pid, ptid, attrs)
                in ring]

    # ---------------------------------------------------------- exporting --
    def export(self, path=None):
        """Write the buffered spans as Chrome trace-event JSON (one
        ``traceEvents`` array Perfetto / chrome://tracing load as-is):
        per-thread lanes with thread-name metadata, one complete ("X")
        event per span carrying span/parent ids in ``args``, and flow
        arrows ("s"/"f") wherever a child ran on a different thread
        than its parent — the rendering of a propagated context.

        ``path`` defaults to the at-exit destination
        (:func:`default_export_path`). Returns the path written."""
        if path is None:
            path = default_export_path()
        if path is None:
            raise ValueError(
                "no export path: pass one, or set MXNET_TPU_TRACE_DIR "
                "(or MXNET_TPU_TRACE=<file.json>)")
        data = self.to_chrome_trace()
        payload = json.dumps(data)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(payload)
        obs = self._metrics()
        obs["exports"].inc()
        obs["export_bytes"].inc(len(payload))
        return path

    def to_chrome_trace(self):
        """The export as a dict (``{"traceEvents": [...]}``)."""
        spans = self.snapshot()
        pid = os.getpid()
        events = [{"ph": "M", "name": "process_name", "pid": pid,
                   "tid": 0, "args": {"name": f"mxnet_tpu_torch host {pid}"}}]
        threads = {}
        for s in spans:
            threads.setdefault(s["tid"], s["thread"])
        for tid, tname in sorted(threads.items()):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
        by_id = {s["span_id"]: s for s in spans}
        for s in spans:
            args = {"span_id": s["span_id"]}
            if s["parent_id"] is not None:
                args["parent_id"] = s["parent_id"]
            args.update(s["attrs"])
            events.append({"ph": "X", "name": s["name"], "cat": s["cat"],
                           "pid": pid, "tid": s["tid"], "ts": s["ts_us"],
                           "dur": max(s["dur_us"], 1), "args": args})
            # a cross-thread parent cannot nest by timestamp containment;
            # a flow arrow draws the causal hand-off instead
            parent = by_id.get(s["parent_id"])
            if parent is not None and parent["tid"] != s["tid"]:
                fid = s["span_id"]
                events.append({"ph": "s", "id": fid, "pid": pid,
                               "name": "ctx", "cat": "ctx",
                               "tid": parent["tid"],
                               "ts": parent["ts_us"]})
                events.append({"ph": "f", "bp": "e", "id": fid,
                               "pid": pid, "name": "ctx", "cat": "ctx",
                               "tid": s["tid"], "ts": s["ts_us"]})
        return {"traceEvents": events, "displayTimeUnit": "ms"}


class _Attach:
    __slots__ = ("_parent", "_token")

    def __init__(self, parent):
        self._parent = parent
        self._token = None

    def __enter__(self):
        self._token = _CURRENT.set(self._parent)
        return self._parent

    def __exit__(self, *exc):
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        return False


# ------------------------------------------------------------ validation --

def validate_chrome_trace(data):
    """Assert ``data`` (dict, JSON text, or a path to a JSON file) is a
    well-formed Chrome trace-event document Perfetto will load: a
    ``traceEvents`` list whose members carry the per-phase required
    fields. Raises ``ValueError`` with the first offence; returns the
    number of "X" (complete) events. This is the checker
    ``tools/metrics_dump.py --smoke`` and the tier-1 tracing tests run
    against every export."""
    if isinstance(data, (str, bytes, os.PathLike)) and \
            os.path.exists(os.fspath(data)):
        with open(data) as f:
            data = f.read()
    if isinstance(data, (str, bytes)):
        data = json.loads(data)
    if not isinstance(data, dict) or \
            not isinstance(data.get("traceEvents"), list):
        raise ValueError("trace document must be an object with a "
                         "'traceEvents' list")
    n_complete = 0
    for i, e in enumerate(data["traceEvents"]):
        if not isinstance(e, dict):
            raise ValueError(f"traceEvents[{i}]: not an object")
        ph = e.get("ph")
        if not isinstance(ph, str) or not ph:
            raise ValueError(f"traceEvents[{i}]: missing 'ph'")
        if not isinstance(e.get("name"), str):
            raise ValueError(f"traceEvents[{i}]: missing 'name'")
        for key in ("pid", "tid"):
            if not isinstance(e.get(key), int):
                raise ValueError(f"traceEvents[{i}]: missing '{key}'")
        if ph == "X":
            n_complete += 1
            for key in ("ts", "dur"):
                v = e.get(key)
                if not isinstance(v, (int, float)) or v < 0:
                    raise ValueError(
                        f"traceEvents[{i}]: bad '{key}': {v!r}")
        elif ph in ("s", "t", "f"):
            if "id" not in e or not isinstance(e.get("ts"), (int, float)):
                raise ValueError(f"traceEvents[{i}]: flow event needs "
                                 "'id' and 'ts'")
        elif ph == "M":
            if not isinstance(e.get("args"), dict):
                raise ValueError(f"traceEvents[{i}]: metadata event "
                                 "needs 'args'")
    return n_complete


# ------------------------------------------------------------- singleton --

def _env_truthy(v):
    return bool(v) and v.strip().lower() not in ("0", "off", "false",
                                                 "no", "")


def _env_export_file(v):
    """A MXNET_TPU_TRACE value that names a file doubles as the at-exit
    export path (`MXNET_TPU_TRACE=run/trace.json`)."""
    if v and (os.sep in v or v.endswith(".json")):
        return v
    return None


def default_export_path():
    """Where an argument-less export lands: the file named by
    ``MXNET_TPU_TRACE`` (if it names one), else
    ``MXNET_TPU_TRACE_DIR/trace_<pid>.json``, else None."""
    f = _env_export_file(os.environ.get("MXNET_TPU_TRACE", ""))
    if f:
        return f
    d = os.environ.get("MXNET_TPU_TRACE_DIR")
    if d:
        return os.path.join(d, f"trace_{os.getpid()}.json")
    return None


_global = None
_global_lock = threading.Lock()


def get_tracer():
    """The process tracer. First call reads ``MXNET_TPU_TRACE`` — a
    truthy value enables recording immediately and, when an export path
    is derivable (:func:`default_export_path`), registers an at-exit
    export so instrumented processes need zero tracing code. Cheap to
    call per request/step: after the first call it is one global read,
    no lock."""
    global _global
    if _global is not None:
        return _global
    with _global_lock:
        if _global is None:
            _global = Tracer()
            env = os.environ.get("MXNET_TPU_TRACE", "")
            if _env_truthy(env):
                _global.enable()
                if default_export_path():
                    import atexit
                    atexit.register(_safe_export, _global)
        return _global


def _safe_export(tracer):
    try:
        tracer.export()
    except Exception:
        pass

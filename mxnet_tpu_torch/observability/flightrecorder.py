"""Flight recorder: an always-on, strictly bounded serving black box
(the port of ``mxnet_tpu/observability/flightrecorder.py``).

The metrics registry answers "how much", the tracer answers "in what
order" — this module answers the post-mortem question both leave open:
*which requests, which control-plane decisions, which engine state* at
the moment an incident fired. Three pieces:

- **event ring.** Per-request lifecycle events (submit → queue →
  admit/shed → prefill chunks → decode steps → served/evicted, carrying
  req id / tenant / adapter and the request's trace span id) and
  discrete control-plane decisions (scheduler preempt/evict, KV
  reclaim/COW, adapter fault-in/evict, circuit-breaker transitions,
  fleet swap phases) land in ONE fixed-size ring
  (``MXNET_TPU_FLIGHT_RING`` entries, default 4096) with counted drops
  — a week-long serving process cannot leak, and the *most recent*
  window is always on hand.
- **trigger layer.** :meth:`FlightRecorder.dump` writes an atomic
  post-mortem bundle. It fires automatically when an SLO's status
  enters page/breach (the reference's ``SLOEngine`` calls
  :meth:`slo_dump` on the transition; the port's waits with
  ``observability/slo.py``), when a serving worker dies
  (``InjectedCrash``/untyped — ``LLMServer`` calls :meth:`crash_dump`
  from its worker-death path, *before* cleanup so the bundle shows
  the dying state), or manually. ``MXNET_TPU_FLIGHT_TRIGGERS``
  (comma list ``slo,crash``) gates the automatic triggers; manual
  ``dump()`` always works while the recorder is enabled.
- **statusz surface.** Long-lived components (:class:`LLMServer`,
  whose status embeds its :class:`LLMEngine`'s)
  :meth:`register` themselves by weakref and expose ``debug_status()``
  — queue depths, KV block partition, bucket/program warmth, adapter
  residency, breaker states, in-flight sequences with ages — which
  every bundle embeds and :meth:`status` serves live.

A bundle is a directory of JSON files written with
``resilience.atomic`` semantics — every file lands via
temp+fsync+rename, and ``MANIFEST.json`` (written LAST, after a
``faults.point("flight.dump")`` chaos site) carries per-file CRC32 and
byte counts, so a partially written bundle is detectable and a
complete manifest proves a complete bundle:

====================  ================================================
file                  contents
====================  ================================================
``events.json``       the flight event ring (oldest first)
``trace.json``        ``get_tracer().snapshot()`` — the span ring
``metrics_then.json`` registry snapshot at enable()/previous dump
``metrics_now.json``  registry snapshot at dump time (the pair diffs)
``slo.json``          the triggering SLO reports with burn windows
``status.json``       ``debug_status()`` of every registered object
``exemplars.json``    histogram bucket exemplars (req id, span id)
``MANIFEST.json``     bundle metadata + per-file crc32/bytes
====================  ================================================

Every component of a bundle is bounded by construction (both rings are
fixed-size, exemplars are capped per bucket, snapshots are metric-count
sized), so bundle size is bounded too — and recorded on
``mxtpu_flight_bundle_bytes_total``.

Integration rules (the tracer's discipline):

- **off = free.** ``get_flightrecorder()`` returns ONE shared
  process-wide recorder; while disabled, :meth:`event` returns before
  touching anything — no tuple, dict or counter write per call
  (asserted via ``mxtpu_flight_events_total`` staying flat). Call
  sites that must *build* attrs guard with ``if recorder.enabled:``.
- **bounded memory.** The ring never grows; overwrites count on
  ``mxtpu_flight_events_dropped_total``.
- **zero captures.** Recording and dumping touch host state only —
  nothing here runs inside a captured step, so steady-state serving
  with the recorder on builds and captures nothing
  (``CompileCounter`` stays at 0).

Env vars: ``MXNET_TPU_FLIGHT`` (truthy enables at first use),
``MXNET_TPU_FLIGHT_RING`` (ring capacity, default 4096),
``MXNET_TPU_FLIGHT_DIR`` (bundle directory; a temp dir per dump when
unset), ``MXNET_TPU_FLIGHT_TRIGGERS`` (automatic triggers, default
``slo,crash``). ``tools/flight_inspect.py`` renders a bundle as a
per-request waterfall + decision log, verifies manifests, and diffs
two bundles.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
import weakref

__all__ = ["FlightRecorder", "get_flightrecorder",
           "flight_ring_capacity", "flight_triggers", "BUNDLE_FILES",
           "DEFAULT_RING"]

DEFAULT_RING = 4096
AUTO_TRIGGERS = ("slo", "crash")

# data files every complete bundle carries (MANIFEST.json indexes them)
BUNDLE_FILES = ("events.json", "trace.json", "metrics_then.json",
                "metrics_now.json", "slo.json", "status.json",
                "exemplars.json")

# histograms whose bucket exemplars a bundle embeds: the hot serving
# latency paths an SLO breach points into
EXEMPLAR_HISTOGRAMS = ("mxtpu_serving_latency_seconds",
                       "mxtpu_llm_ttft_seconds",
                       "mxtpu_llm_request_seconds")


def flight_ring_capacity():
    """Ring capacity: ``MXNET_TPU_FLIGHT_RING`` or the default."""
    try:
        n = int(os.environ.get("MXNET_TPU_FLIGHT_RING",
                               DEFAULT_RING) or DEFAULT_RING)
    except ValueError:
        return DEFAULT_RING
    return max(16, n)


def flight_triggers():
    """The enabled AUTOMATIC triggers, as a frozenset:
    ``MXNET_TPU_FLIGHT_TRIGGERS`` (comma list, unknown names ignored)
    or both of ``slo``/``crash``. Manual dumps are always allowed."""
    v = os.environ.get("MXNET_TPU_FLIGHT_TRIGGERS")
    if v is None or not v.strip():
        return frozenset(AUTO_TRIGGERS)
    return frozenset(t.strip() for t in v.split(",")
                     if t.strip() in AUTO_TRIGGERS)


class FlightRecorder:
    """Bounded black-box recorder. Use the module singleton
    (:func:`get_flightrecorder`); fresh instances exist for tests."""

    def __init__(self, ring=None, registry=None, out_dir=None,
                 triggers=None):
        self._lock = threading.Lock()
        self._ring = collections.deque(
            maxlen=ring if ring else flight_ring_capacity())
        self._enabled = False
        self._out_dir = out_dir
        # None = read MXNET_TPU_FLIGHT_TRIGGERS at fire time
        self._triggers = (frozenset(triggers) if triggers is not None
                          else None)
        self._registry = registry
        self._objects = {}          # guarded-by: _lock (name -> weakref)
        self._baseline = None       # guarded-by: _lock (snapshot pair)
        self._dumps = 0             # guarded-by: _lock
        self._epoch_ns = time.monotonic_ns()
        self._obs = None

    # ------------------------------------------------------ lifecycle --
    @property
    def enabled(self):
        return self._enabled

    def enable(self, ring=None, out_dir=None):
        """Turn event recording on (idempotent). ``ring`` resizes the
        buffer; ``out_dir`` sets the bundle directory. Captures the
        "then" half of the metrics snapshot pair every later bundle
        embeds."""
        with self._lock:
            if ring and ring != self._ring.maxlen:
                self._ring = collections.deque(self._ring, maxlen=ring)
            if out_dir is not None:
                self._out_dir = out_dir
            self._enabled = True
            self._metrics()
            self._baseline = self._reg().snapshot()
        return self

    def disable(self):
        self._enabled = False
        return self

    def clear(self):
        with self._lock:
            self._ring.clear()

    def _reg(self):
        if self._registry is None:
            from .registry import get_registry
            self._registry = get_registry()
        return self._registry

    def _metrics(self):
        if self._obs is None:
            reg = self._reg()
            self._obs = {
                "events": reg.counter(
                    "mxtpu_flight_events_total",
                    "Flight-recorder events recorded (0 while the "
                    "recorder is off — the zero-overhead contract)."),
                "dropped": reg.counter(
                    "mxtpu_flight_events_dropped_total",
                    "Flight events evicted from the bounded ring "
                    "before a dump read them."),
                "dumps": reg.counter(
                    "mxtpu_flight_dumps_total",
                    "Post-mortem bundles written, by trigger.",
                    ("trigger",)),
                "bundle_bytes": reg.counter(
                    "mxtpu_flight_bundle_bytes_total",
                    "Total bytes of flight bundles written."),
            }
        return self._obs

    # ------------------------------------------------------ recording --
    def event(self, kind, req=None, tenant=None, attrs=None):
        """Record one event. ``kind`` is a dotted decision/lifecycle
        name (``llm.submit``, ``serving.shed``, ``kv.cow``,
        ``fleet.swap``, ``breaker`` ...); ``req`` a request key
        (``llm:<seq_id>`` / ``srv:<rid>``) for per-request waterfalls,
        None for pure control-plane decisions. Returns immediately —
        allocating nothing — while disabled."""
        if not self._enabled:
            return
        rec = ((time.monotonic_ns() - self._epoch_ns) // 1000, kind,
               req, tenant, attrs)
        obs = self._metrics()
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                obs["dropped"].inc()
            self._ring.append(rec)
        obs["events"].inc()

    # --------------------------------------------------- statusz surface --
    def register(self, name, obj):
        """Track ``obj`` (weakly) under ``name``; its
        ``debug_status()`` enters every bundle and :meth:`status`.
        Re-registering a name replaces the old entry (fleet swaps)."""
        with self._lock:
            self._objects[name] = weakref.ref(obj)

    def status(self):
        """Live ``{name: debug_status()}`` of every registered object
        still alive. Best-effort: one object's failure reports as an
        ``error`` entry instead of poisoning the surface (this runs
        while servers may be dying — that is the point)."""
        with self._lock:
            objs = list(self._objects.items())
        out = {}
        for name, ref in objs:
            obj = ref()
            if obj is None:
                continue
            try:
                out[name] = obj.debug_status()
            except Exception as exc:
                out[name] = {"error": repr(exc)}
        return out

    # ----------------------------------------------------- introspection --
    def snapshot(self):
        """Buffered events, oldest first, as dicts."""
        with self._lock:
            ring = list(self._ring)
        return [{"t_us": t, "kind": k, "req": r, "tenant": ten,
                 "attrs": attrs or {}}
                for (t, k, r, ten, attrs) in ring]

    def stats(self):
        with self._lock:
            obs = self._metrics()
            return {"enabled": self._enabled,
                    "buffered": len(self._ring),
                    "capacity": self._ring.maxlen,
                    "recorded": int(obs["events"].value),
                    "dropped": int(obs["dropped"].value),
                    "dumps": self._dumps}

    def active_triggers(self):
        return (self._triggers if self._triggers is not None
                else flight_triggers())

    # ---------------------------------------------------------- dumping --
    def _exemplars(self):
        from .exemplars import collect
        return collect(self._reg(), EXEMPLAR_HISTOGRAMS)

    def dump(self, trigger="manual", reason=None, slo_reports=None,
             out_dir=None, extra=None):
        """Write one post-mortem bundle; returns its directory path.

        Every data file goes down with ``resilience.atomic_write``
        (temp + fsync + rename); ``MANIFEST.json`` is written LAST —
        after the ``faults.point("flight.dump")`` chaos site — with
        each file's crc32/bytes, so readers (``flight_inspect
        --check``) can prove the bundle complete and uncorrupted.
        Also refreshes the "then" metrics baseline, so consecutive
        bundles pair up back to back."""
        # lazy imports: resilience imports observability.registry, so a
        # module-level import here would cycle
        from ..resilience import faults
        from ..resilience.atomic import atomic_write
        from .tracing import get_tracer
        reg = self._reg()
        with self._lock:
            baseline = self._baseline
            n = self._dumps
            self._dumps = n + 1
        base = (out_dir or self._out_dir
                or os.environ.get("MXNET_TPU_FLIGHT_DIR"))
        if not base:
            import tempfile
            base = tempfile.mkdtemp(prefix="mxtpu-flight-")
        bundle = os.path.join(
            base, f"flight_{os.getpid()}_{n:03d}_{trigger}")
        os.makedirs(bundle, exist_ok=True)
        now_snap = reg.snapshot()
        payloads = {
            "events.json": self.snapshot(),
            "trace.json": get_tracer().snapshot(),
            "metrics_then.json": baseline or {},
            "metrics_now.json": now_snap,
            "slo.json": slo_reports or {},
            "status.json": self.status(),
            "exemplars.json": self._exemplars(),
        }
        files = {}
        total = 0
        for fname, payload in payloads.items():
            path = os.path.join(bundle, fname)
            data = json.dumps(payload, sort_keys=True,
                              default=repr).encode()
            with atomic_write(path) as sink:
                sink.write(data)
            files[fname] = {"crc32": sink.crc32, "bytes": sink.nbytes}
            total += sink.nbytes
        # chaos site: a scripted crash here leaves data files behind
        # but NO manifest — exactly the torn-bundle state --check and
        # the resilience tests probe
        faults.point("flight.dump")
        manifest = {
            "bundle": os.path.basename(bundle),
            "trigger": trigger,
            "reason": reason,
            "created_unix": time.time(),
            "pid": os.getpid(),
            "files": files,
            "stats": self.stats(),
        }
        if extra:
            manifest["extra"] = extra
        mpath = os.path.join(bundle, "MANIFEST.json")
        with atomic_write(mpath) as sink:
            sink.write(json.dumps(manifest, sort_keys=True,
                                  default=repr).encode())
        total += sink.nbytes
        obs = self._metrics()
        obs["dumps"].labels(trigger=trigger).inc()
        obs["bundle_bytes"].inc(total)
        with self._lock:
            self._baseline = now_snap
        return bundle

    def crash_dump(self, exc, server=None):
        """Best-effort bundle on worker death — called from a dying
        serving loop's ``except BaseException`` path, BEFORE cleanup.
        Never raises (the caller is already unwinding a crash; a dump
        failure — including an armed ``flight.dump`` chaos site — must
        not mask the original exception). Returns the bundle path or
        None."""
        if not self._enabled or "crash" not in self.active_triggers():
            return None
        try:
            return self.dump(
                trigger="crash",
                reason=f"{type(exc).__name__}: {exc}",
                extra={"server": server} if server else None)
        except BaseException:
            return None

    def slo_dump(self, fired, reports):
        """Bundle on an SLO status transition INTO page/breach.
        ``fired`` names the SLOs that crossed; ``reports`` is the full
        ``SLOEngine.evaluate`` result (burn windows ride into
        ``slo.json``). Gated by the ``slo`` trigger; returns the
        bundle path or None."""
        if not self._enabled or "slo" not in self.active_triggers():
            return None
        return self.dump(trigger="slo", reason=",".join(fired),
                         slo_reports=reports)


# ------------------------------------------------------------- singleton --

def _env_truthy(v):
    return bool(v) and v.strip().lower() not in ("0", "off", "false",
                                                 "no", "")


_global = None
_global_lock = threading.Lock()


def get_flightrecorder():
    """The ONE process-wide recorder every instrumentation site shares
    (servers cache it at construction — enable/disable toggles the
    same object). First call reads ``MXNET_TPU_FLIGHT``: a truthy
    value enables recording immediately, so instrumented processes
    need zero flight code. Cheap per call: after the first it is one
    global read, no lock."""
    global _global
    if _global is not None:
        return _global
    with _global_lock:
        if _global is None:
            rec = FlightRecorder()
            if _env_truthy(os.environ.get("MXNET_TPU_FLIGHT", "")):
                rec.enable()
            _global = rec
        return _global

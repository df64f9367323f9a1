"""Serving telemetry of the port (mirrors ``mxnet_tpu/serving/telemetry.py``):
the compile count and the series every serving front end shares, on the
:mod:`mxnet_tpu_torch.observability` registry under the reference's
``mxtpu_serving_*`` names, labeled by server name.

- :func:`compile_count` / :class:`CompileCounter` — kernel library builds
  and loads (:func:`mxnet_tpu_torch.kernels.build_count`) plus CUDA graph
  captures (:func:`mxnet_tpu_torch.kernels.capture_count`) in this
  process, read from ``mxtpu_xla_compile_total``, as the reference's
  count of XLA compiles; the serving
  contract is that it does not move after ``warmup()``.
- :class:`ServingStats` — the single-shot ``ModelServer``'s counters and
  bounded fixed-edge latency histograms; ``snapshot()`` returns queue
  depth, wait times, padded-waste fraction, p50/p95/p99 latency and
  throughput in the reference's schema.
- :class:`OverloadStats` / :class:`TenantStats` — shed, deadline, poison
  and breaker series, and per-tenant outcomes; ``ServingStats`` and
  ``LLMStats`` (:mod:`.llm.metrics`) embed both.
- :class:`EventLog` — JSON-lines event sink (one dict per line, ``ts``
  stamped): the ``ModelServer``'s per-batch records and lifecycle
  events.
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref

from ..observability import compilemon as _compilemon
from ..observability import get_registry
from ..observability.registry import DEFAULT_TIME_BUCKETS

__all__ = ["compile_count", "CompileCounter", "ServingStats", "EventLog",
           "OverloadStats", "TenantStats"]


def compile_count():
    """Kernel builds and loads plus graph captures in this process: a
    view over ``mxtpu_xla_compile_total`` (``observability/
    compilemon.py``), as the reference's is over its compile counter."""
    return _compilemon.compile_count()


class CompileCounter:
    """Context manager measuring builds and captures inside its block::

        with CompileCounter() as cc:
            server.generate(prompt, 8)
        assert cc.count == 0
    """

    def __init__(self):
        self._start = None
        self.count = 0

    def __enter__(self):
        self._start = compile_count()
        return self

    def __exit__(self, *exc):
        self.count = compile_count() - self._start
        return False


# Serving latencies on CPU tests run ~100us; on a loaded server the tail
# can reach seconds. The shared registry edges (minus the 60s top edge no
# sane request latency reaches) keep latency histograms directly
# comparable with every other subsystem's.
_LATENCY_BUCKETS = DEFAULT_TIME_BUCKETS[:-1]

# Each live ServingStats / LLMStats needs its own label children or two
# same-named servers in one process would zero and then merge each
# other's series. A name whose previous holder is gone (garbage-collected
# — the common server-restart pattern) is RE-USED, so dashboards keyed on
# {server="x"} follow the restarted server instead of reading a frozen
# series; only a name whose holder is still alive gets a "#N" suffix.
_NAME_HOLDERS = {}     # label -> weakref to the stats object holding it
_NAME_LOCK = threading.Lock()


def _claim_server_label(name, holder):
    with _NAME_LOCK:
        label = name
        n = 1
        while True:
            ref = _NAME_HOLDERS.get(label)
            if ref is None or ref() is None:
                _NAME_HOLDERS[label] = weakref.ref(holder)
                return label
            n += 1
            label = f"{name}#{n}"


class OverloadStats:
    """The overload/failure series BOTH serving front ends expose
    under one catalog (``mxtpu_serving_*`` labeled by server name):
    requests shed at admission (by reason), requests failed on an
    expired end-to-end deadline, poison rows isolated out of batches,
    and the circuit-breaker state gauge (0 closed / 1 open / 2
    half-open). ``ServingStats`` and ``LLMStats`` both embed one, so a
    dashboard reads overload behavior identically for single-shot and
    decode serving."""

    def __init__(self, registry, server_label):
        r, lbl = registry, ("server",)
        s = {"server": server_label}
        self._server = server_label
        self._shed_metric = r.counter(
            "mxtpu_serving_shed_total",
            "Requests shed at admission instead of queued, by reason "
            "(queue_full, deadline_unmeetable, breaker_open).",
            ("server", "reason"))
        self._deadline = r.counter(
            "mxtpu_serving_deadline_expired_total",
            "Requests failed because their end-to-end deadline expired "
            "before a result existed (never dispatched past expiry).",
            lbl).labels(**s)
        self._poison = r.counter(
            "mxtpu_serving_poison_isolated_total",
            "Requests isolated out of a failing batch by bisect-retry "
            "and failed with the original dispatch exception.",
            lbl).labels(**s)
        self._breaker = r.gauge(
            "mxtpu_serving_breaker_state",
            "Dispatch circuit breaker: 0 closed, 1 open (rejecting), "
            "2 half-open (probing).", lbl).labels(**s)
        self._shed_lock = threading.Lock()
        self._shed_children = {}    # guarded-by: _shed_lock

    def record_shed(self, reason):
        with self._shed_lock:
            child = self._shed_children.get(reason)
            if child is None:
                child = self._shed_metric.labels(server=self._server,
                                                 reason=reason)
                self._shed_children[reason] = child
        child.inc()

    def record_deadline_expired(self, n=1):
        self._deadline.inc(n)

    def record_poison(self, n=1):
        self._poison.inc(n)

    def record_breaker_state(self, state):
        self._breaker.set(state)

    def reset(self):
        with self._shed_lock:
            self._deadline.reset()
            self._poison.reset()
            self._breaker.reset()
            for child in self._shed_metric.children():
                if child.labels_dict.get("server") == self._server:
                    child.reset()
            self._shed_children = {}

    def snapshot_into(self, snap):
        """Merge the overload counters into a stats snapshot dict."""
        with self._shed_lock:
            snap["shed"] = {r: int(c.value)
                            for r, c in self._shed_children.items()
                            if c.value}
        snap["requests_shed"] = sum(snap["shed"].values())
        snap["deadline_expired"] = int(self._deadline.value)
        snap["poison_isolated"] = int(self._poison.value)
        snap["breaker_state"] = int(self._breaker.value)
        return snap


class TenantStats:
    """Per-tenant outcome attribution, shared by both front ends.

    One counter ``<metric>{server,tenant,outcome}`` (outcomes:
    submitted / served / shed / expired / evicted / failed) plus an
    optional per-tenant token counter for decode serving. Tenancy is
    OPT-IN per request (``submit(..., tenant=)``): an untagged request
    (tenant None) creates no series, so single-tenant deployments pay
    zero extra cardinality. This is the dimension
    ``tools/load_replay.py``'s skewed traffic and the capacity model's
    per-tenant shares are attributed on."""

    OUTCOMES = ("submitted", "served", "shed", "expired", "evicted",
                "failed")

    def __init__(self, registry, metric_name, server_label,
                 tokens_metric=None):
        self._server = server_label
        self._requests = registry.counter(
            metric_name,
            "Per-tenant request outcomes (submitted/served/shed/"
            "expired/evicted/failed); tagged requests only.",
            ("server", "tenant", "outcome"))
        self._tokens = registry.counter(
            tokens_metric,
            "Tokens generated for tagged tenants' requests.",
            ("server", "tenant")) if tokens_metric else None
        self._lock = threading.Lock()
        self._children = {}         # guarded-by: _lock

    def record(self, tenant, outcome, n=1):
        if tenant is None:
            return
        key = (str(tenant), outcome)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._requests.labels(
                    server=self._server, tenant=key[0], outcome=outcome)
                self._children[key] = child
        child.inc(n)

    def record_tokens(self, tenant, n):
        if tenant is None or self._tokens is None:
            return
        self._tokens.labels(server=self._server,
                            tenant=str(tenant)).inc(n)

    def reset(self):
        with self._lock:
            for metric in (self._requests, self._tokens):
                if metric is None:
                    continue
                for child in metric.children():
                    if child.labels_dict.get("server") == self._server:
                        child.reset()
            self._children = {}

    def snapshot(self):
        """{tenant: {outcome: n}} for this server's tagged tenants."""
        out = {}
        with self._lock:
            for (tenant, outcome), child in self._children.items():
                if child.value:
                    out.setdefault(tenant, {})[outcome] = \
                        int(child.value)
        return out


class ServingStats:
    """Aggregated serving counters; every method is thread-safe.

    All series live on the shared registry labeled
    ``{server="<name>"}``. A restarted server (previous instance
    garbage-collected) re-claims its name — its children are reset and
    continue under the same label; a name still held by a LIVE instance
    gets a ``#N`` suffix instead, so concurrent same-named servers
    never share or reset each other's children. ``snapshot()`` reads
    this instance's own label children, while the exposition keeps the
    one-scrape view across every server the process ran.
    """

    def __init__(self, server="serve", registry=None):
        self._reg = registry if registry is not None else get_registry()
        self._server = _claim_server_label(str(server), self)
        r, lbl = self._reg, ("server",)
        s = {"server": self._server}
        self._submitted = r.counter(
            "mxtpu_serving_requests_submitted_total",
            "Requests accepted into the batching queue.", lbl).labels(**s)
        self._completed = r.counter(
            "mxtpu_serving_requests_completed_total",
            "Requests resolved with a result.", lbl).labels(**s)
        self._failed = r.counter(
            "mxtpu_serving_requests_failed_total",
            "Requests resolved with an error.", lbl).labels(**s)
        self._batches = r.counter(
            "mxtpu_serving_batches_total",
            "Micro-batches executed.", lbl).labels(**s)
        self._rows = r.counter(
            "mxtpu_serving_rows_total",
            "Real (unpadded) rows executed.", lbl).labels(**s)
        self._padded = r.counter(
            "mxtpu_serving_padded_rows_total",
            "Pad rows executed (bucket size minus real rows).",
            lbl).labels(**s)
        self._queue_depth = r.gauge(
            "mxtpu_serving_queue_depth",
            "Requests waiting in the batching queue.", lbl).labels(**s)
        self._wait = r.histogram(
            "mxtpu_serving_wait_seconds",
            "Per-request queue wait before dispatch.", lbl,
            buckets=_LATENCY_BUCKETS).labels(**s)
        self._service = r.histogram(
            "mxtpu_serving_service_seconds",
            "Per-batch model execution time.", lbl,
            buckets=_LATENCY_BUCKETS).labels(**s)
        self._latency = r.histogram(
            "mxtpu_serving_latency_seconds",
            "Per-request end-to-end latency (wait + service).", lbl,
            buckets=_LATENCY_BUCKETS).labels(**s)
        # no throughput gauge: a gauge only updated on snapshot() reads
        # stale from a pure scrape; rate(requests_completed_total) is
        # the scrape-side equivalent, snapshot() computes it locally
        self._hits_metric = r.counter(
            "mxtpu_serving_bucket_hits_total",
            "Micro-batches dispatched per shape bucket.",
            ("server", "bucket"))
        self._overload = OverloadStats(r, self._server)
        self._tenants = TenantStats(
            r, "mxtpu_serving_tenant_requests_total", self._server)
        self._lock = threading.Lock()
        self._bucket_hits = {}
        self.reset()

    @property
    def server_label(self):
        """The registry label this instance's series carry (the claim
        protocol may have suffixed the requested name)."""
        return self._server

    def reset(self):
        with self._lock:
            self._t_start = time.monotonic()
            for c in (self._submitted, self._completed, self._failed,
                      self._batches, self._rows, self._padded,
                      self._queue_depth, self._wait, self._service,
                      self._latency):
                c.reset()
            # include bucket-hit children left by a previous holder of
            # this (re-claimed) server label, not just our own dict
            for child in self._hits_metric.children():
                if child.labels_dict.get("server") == self._server:
                    child.reset()
            self._bucket_hits = {}
        self._overload.reset()
        self._tenants.reset()

    def _hit_child(self, bucket):
        child = self._bucket_hits.get(bucket)
        if child is None:
            child = self._hits_metric.labels(server=self._server,
                                             bucket=bucket)
            self._bucket_hits[bucket] = child
        return child

    # ------------------------------------------------------- recording --
    def record_submit(self):
        self._submitted.inc()

    def record_queue_depth(self, depth):
        self._queue_depth.set(depth)

    def record_batch(self, n, bucket, wait_s_each, service_s,
                     exemplars=None):
        """One executed micro-batch: n real rows padded to ``bucket``.
        ``exemplars`` (optional, aligned with ``wait_s_each``): one
        ``(req, span_id)`` per row, attached to each row's latency
        bucket — built by the server only while the flight recorder
        is on."""
        with self._lock:
            self._batches.inc()
            self._rows.inc(n)
            self._padded.inc(bucket - n)
            self._hit_child(bucket).inc()
            self._service.observe(service_s)
            for i, w in enumerate(wait_s_each):
                self._wait.observe(w)
                self._latency.observe(
                    w + service_s,
                    exemplar=exemplars[i] if exemplars else None)
            self._completed.inc(n)

    def record_failure(self, n):
        self._failed.inc(n)

    # ------------------------------------------------- tenant series --
    def record_tenant(self, tenant, outcome, n=1):
        """Per-tenant outcome attribution (no-op for tenant None)."""
        self._tenants.record(tenant, outcome, n)

    # ------------------------------------------------ overload series --
    def record_shed(self, reason):
        self._overload.record_shed(reason)

    def record_deadline_expired(self, n=1):
        self._overload.record_deadline_expired(n)

    def record_poison(self, n=1):
        self._overload.record_poison(n)

    def record_breaker_state(self, state):
        self._overload.record_breaker_state(state)

    def service_p50_s(self):
        """Median per-batch service time (seconds; 0 until observed) —
        the admission controller's estimated-wait input."""
        return self._service.percentile(50)

    # -------------------------------------------------------- snapshot --
    def snapshot(self):
        with self._lock:
            elapsed = max(time.monotonic() - self._t_start, 1e-9)
            rows = self._rows.value
            padded = self._padded.value
            batches = self._batches.value
            completed = self._completed.value
            total_slots = rows + padded
            return self._overload.snapshot_into({
                "requests_submitted": int(self._submitted.value),
                "requests_completed": int(completed),
                "requests_failed": int(self._failed.value),
                "batches": int(batches),
                "queue_depth": int(self._queue_depth.value),
                "avg_batch_size": (rows / batches if batches else 0.0),
                "padded_waste": (padded / total_slots
                                 if total_slots else 0.0),
                "bucket_hits": {b: int(c.value)
                                for b, c in self._bucket_hits.items()
                                if c.value},
                "throughput_rps": completed / elapsed,
                "wait_ms": self._pcts(self._wait),
                "latency_ms": self._pcts(self._latency),
                "service_ms": self._pcts(self._service),
                "tenants": self._tenants.snapshot(),
            })

    @staticmethod
    def _pcts(hist):
        return {"p50": hist.percentile(50) * 1e3,
                "p95": hist.percentile(95) * 1e3,
                "p99": hist.percentile(99) * 1e3}


class EventLog:
    """Append-only JSON-lines sink. ``path`` may come from the
    ``MXNET_TPU_SERVE_EVENT_LOG`` env var; a None path makes every emit
    a no-op so call sites need no guards."""

    def __init__(self, path=None):
        self._lock = threading.Lock()
        self._f = open(path, "a", buffering=1) if path else None

    @classmethod
    def from_env(cls):
        return cls(os.environ.get("MXNET_TPU_SERVE_EVENT_LOG") or None)

    def emit(self, event, **fields):
        if self._f is None:
            return
        rec = {"ts": time.time(), "event": event}
        rec.update(fields)
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            if self._f is not None:
                self._f.write(line + "\n")

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

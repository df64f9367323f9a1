"""Serving telemetry of the port (mirrors ``mxnet_tpu/serving/telemetry.py``):
the compile count and the overload and tenant series every serving front
end shares, on the :mod:`mxnet_tpu_torch.observability` registry under
the reference's ``mxtpu_serving_*`` names, labeled by server name.

- :func:`compile_count` / :class:`CompileCounter` — kernel library builds
  and loads (:func:`mxnet_tpu_torch.kernels.build_count`) plus CUDA graph
  captures (:func:`mxnet_tpu_torch.kernels.capture_count`) in this
  process, as the reference's count of XLA compiles; the serving
  contract is that it does not move after ``warmup()``.
- :class:`OverloadStats` / :class:`TenantStats` — shed, deadline, poison
  and breaker series, and per-tenant outcomes; ``LLMStats``
  (:mod:`.llm.metrics`) embeds both.

The reference's single-shot ``ServingStats`` and ``EventLog`` serve its
``ModelServer``, which is not ported yet (ROADMAP.md §1 item 11).
"""
from __future__ import annotations

import threading
import weakref

from .. import kernels
from ..observability.registry import DEFAULT_TIME_BUCKETS

__all__ = ["compile_count", "CompileCounter", "OverloadStats",
           "TenantStats"]


def compile_count():
    """Kernel builds and loads plus graph captures in this process."""
    return kernels.build_count() + kernels.capture_count()


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

# Each live LLMStats needs its own label children or two same-named
# servers in one process would zero and then merge each other's series.
# A name whose previous holder is gone (garbage-collected — the common
# server-restart pattern) is RE-USED, so dashboards keyed on
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
    half-open). ``LLMStats`` embeds one (as the reference's single-shot
    ``ServingStats`` does), so a dashboard reads overload behavior
    identically for both front ends."""

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

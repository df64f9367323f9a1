"""Fleet telemetry of the port (mirrors
``mxnet_tpu/serving/fleet/metrics.py``): the ``mxtpu_fleet_*`` series on the shared registry, under the
reference's names.

One :class:`FleetStats` per :class:`~.router.FleetRouter`, labeled by
fleet name (claimed through the same weakref protocol server labels
use, so a restarted router re-uses its label instead of forking a
``#2`` series). Training jobs publishing into the router (the
fine-tune loop) and the servers it hosts all write the SAME registry —
one scrape reads the whole story: step timing, per-server serving
series, and the fleet's routing/swap/quota accounting.

Series:

- ``mxtpu_fleet_routed_total{fleet,model,lane}`` — requests admitted
  and handed to a backing server;
- ``mxtpu_fleet_swap_total{fleet,model,phase,outcome}`` — hot-swap
  phase outcomes (``ok`` / ``rolled_back`` / ``failed``);
- ``mxtpu_fleet_swap_seconds{fleet,model}`` — end-to-end publish
  latency (load through prune);
- ``mxtpu_fleet_quota_shed_total{fleet,tenant}`` — requests shed by
  the per-tenant token bucket (typed ``Overloaded(reason="quota")``);
- ``mxtpu_fleet_lane_depth{fleet,lane}`` — Futures currently admitted
  per priority lane and not yet resolved;
- ``mxtpu_fleet_active_version{fleet,model}`` — the committed
  (serving) version number.
"""
from __future__ import annotations

import re
import threading

from ...observability import get_registry
from ...observability.registry import DEFAULT_TIME_BUCKETS
from ..telemetry import _claim_server_label

__all__ = ["FleetStats"]


def _version_number(version):
    """Gauge-able number for a version token: ints pass through,
    strings use their digit run (``"v12"`` -> 12); otherwise -1."""
    if isinstance(version, (int, float)):
        return float(version)
    m = re.search(r"\d+", str(version))
    return float(m.group()) if m else -1.0


class FleetStats:
    """Thread-safe fleet counters over the observability registry."""

    def __init__(self, registry=None, fleet="fleet"):
        r = registry if registry is not None else get_registry()
        self.fleet = _claim_server_label(fleet, self)
        self._routed = r.counter(
            "mxtpu_fleet_routed_total",
            "Requests admitted by the fleet router and handed to a "
            "backing server, by model and priority lane.",
            ("fleet", "model", "lane"))
        self._swap = r.counter(
            "mxtpu_fleet_swap_total",
            "Weight hot-swap phase outcomes: ok (phase completed), "
            "rolled_back (crash before the handover commit — the old "
            "version keeps serving), failed (crash after commit — the "
            "new version serves, the old is retired by the handler).",
            ("fleet", "model", "phase", "outcome"))
        self._swap_seconds = r.histogram(
            "mxtpu_fleet_swap_seconds",
            "End-to-end publish latency: manifest load through old-"
            "replica prune.", ("fleet", "model"),
            buckets=DEFAULT_TIME_BUCKETS)
        self._quota_shed = r.counter(
            "mxtpu_fleet_quota_shed_total",
            "Requests shed by the per-tenant token-bucket quota "
            "(typed Overloaded(reason=\"quota\") — only the greedy "
            "tenant degrades).", ("fleet", "tenant"))
        self._lane_depth = r.gauge(
            "mxtpu_fleet_lane_depth",
            "Futures currently admitted per priority lane and not yet "
            "resolved.", ("fleet", "lane"))
        self._active_version = r.gauge(
            "mxtpu_fleet_active_version",
            "The committed (serving) version number per model; moves "
            "exactly at the hot-swap handover commit.",
            ("fleet", "model"))
        self._lock = threading.Lock()
        self._children = {}     # guarded-by: _lock

    def _child(self, metric, **labels):
        key = (id(metric), tuple(sorted(labels.items())))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = metric.labels(fleet=self.fleet, **labels)
                self._children[key] = child
        return child

    def record_routed(self, model, lane):
        self._child(self._routed, model=model, lane=lane).inc()

    def record_swap(self, model, phase, outcome):
        self._child(self._swap, model=model, phase=phase,
                    outcome=outcome).inc()

    def record_swap_seconds(self, model, seconds):
        self._child(self._swap_seconds, model=model).observe(seconds)

    def record_quota_shed(self, tenant):
        self._child(self._quota_shed, tenant=str(tenant)).inc()

    def set_lane_depth(self, lane, depth):
        self._child(self._lane_depth, lane=lane).set(depth)

    def set_active_version(self, model, version):
        self._child(self._active_version,
                    model=model).set(_version_number(version))

"""Opt-in histogram exemplars: (req id, trace span id) on bucket counts
(the port of ``mxnet_tpu/observability/exemplars.py``).

A fixed-edge histogram tells you *one* request landed in the 250–500ms
bucket; an exemplar tells you *which one* — so an SLO breach links
straight from the offending latency bucket to the request's full span
timeline in a flight bundle (``tools/flight_inspect.py`` performs the
join: exemplar → flight events by req id → trace spans by span id).

Mechanics (OpenMetrics-shaped, zero new sampling paths):

- :meth:`~.registry.HistogramChild.observe` takes an optional
  ``exemplar=(req, span_id)``; when given, the observation's bucket
  keeps it in a small last-K reservoir (``EXEMPLARS_PER_BUCKET``,
  newest wins) under the histogram's existing lock — memory stays
  O(buckets * K) forever;
- passing ``exemplar=None`` (the default everywhere) costs one ``is
  None`` test — recorder-off hot paths allocate nothing, which the
  flight tests counter-assert;
- call sites only BUILD the exemplar tuple when the flight recorder is
  enabled (``LLMStats.record_first_token`` / ``record_completed``
  thread it through), so exemplars are strictly opt-in;
- :func:`collect` snapshots the reservoirs of a named set of
  histograms into the JSON shape ``exemplars.json`` embeds, keyed by
  metric name → label set → bucket upper edge (``le`` semantics, with
  ``+Inf`` for the overflow bucket).
"""
from __future__ import annotations

__all__ = ["EXEMPLARS_PER_BUCKET", "collect", "child_exemplars"]

# last-K reservoir per bucket: enough to name offenders without
# letting a hot bucket grow a sample log
EXEMPLARS_PER_BUCKET = 4


def child_exemplars(child):
    """One :class:`~.registry.HistogramChild`'s reservoirs as
    ``{bucket_index: [{value, req, span_id, ts_unix}, ...]}`` (oldest
    first). Empty when the child never saw an exemplar."""
    ex = child._exemplars
    if not ex:
        return {}
    with child._lock:
        items = [(i, list(lst)) for i, lst in ex.items()]
    return {i: [{"value": v, "req": r, "span_id": s, "ts_unix": ts}
                for (v, r, s, ts) in lst]
            for i, lst in items}


def _edge_name(edges, i):
    return ("%.12g" % edges[i]) if i < len(edges) else "+Inf"


def collect(registry, names):
    """Snapshot the exemplar reservoirs of ``names`` (histogram metric
    names) from ``registry``: ``{metric: [{labels, buckets: {le:
    [exemplar, ...]}}, ...]}`` — the ``exemplars.json`` bundle shape.
    Metrics absent from the registry (subsystem never instantiated)
    are skipped."""
    from .registry import Histogram
    out = {}
    for name in names:
        m = registry.get(name)
        if m is None or not isinstance(m, Histogram):
            continue
        series = []
        for child in m.children():
            by_idx = child_exemplars(child)
            if not by_idx:
                continue
            series.append({
                "labels": child.labels_dict,
                "buckets": {_edge_name(m.buckets, i): exs
                            for i, exs in sorted(by_idx.items())},
            })
        if series:
            out[name] = series
    return out

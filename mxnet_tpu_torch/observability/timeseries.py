"""Bounded in-process time series over registry snapshots (a copy of
``mxnet_tpu/observability/timeseries.py``).

The registry (:mod:`.registry`) is cumulative-only by design: counters
climb forever and histograms accumulate since process start. Anything
that wants a *rate* — an autoscaler, an SLO burn-rate window, a
capacity model — needs the same metric at two points in time and the
delta between them. :class:`TimeSeriesRing` is that second axis: a
bounded ring of periodic ``registry.snapshot()`` records with
delta-aware queries on top:

- :meth:`TimeSeriesRing.rate` — per-second increase of a counter (or a
  histogram's count) over a trailing window, reset-aware;
- :meth:`TimeSeriesRing.percentile_over` — a histogram percentile over
  ONLY the observations that landed inside the window (the cumulative
  ``Histogram.percentile`` blends the whole process lifetime, which
  hides a fresh latency regression behind hours of healthy history);
- :meth:`TimeSeriesRing.series` — raw ``(ts, value)`` pairs for a
  gauge/counter, for plotting or export.

Design rules follow the registry's: stdlib only, thread-safe, bounded
memory (``MXNET_TPU_TS_RING`` snapshots, oldest evicted first — a
long-lived server records forever without growing). The ring itself
reports through the registry it samples (``mxtpu_ts_*``), so snapshot
cadence and evictions are visible in the same exposition.

This module is the in-process analogue of a Prometheus TSDB +
``rate()``/``histogram_quantile()`` — the signal source
:mod:`mxnet_tpu_torch.observability.slo` evaluates burn rates from and
:mod:`mxnet_tpu_torch.observability.capacity` derives sustainable load from.
``tools/metrics_dump.py --delta`` is the offline/manual twin of
:meth:`rate` over two JSONL snapshot files.
"""
from __future__ import annotations

import collections
import os
import threading
import time

__all__ = ["TimeSeriesRing", "match_series", "scalar_value",
           "hist_collect", "diff_cum_counts", "percentile_from_counts"]

DEFAULT_RING = 512


def _env_ring():
    v = os.environ.get("MXNET_TPU_TS_RING")
    if not v:
        return DEFAULT_RING
    try:
        n = int(v)
    except ValueError:
        import warnings
        warnings.warn(f"MXNET_TPU_TS_RING={v!r} is not an integer; "
                      f"using {DEFAULT_RING}")
        return DEFAULT_RING
    return max(2, n)


def _to_float(v):
    """Snapshot values stringify non-finite floats (``"NaN"`` etc. —
    see registry._json_num); ``float()`` parses them back."""
    return float(v)


# ------------------------------------------------- snapshot queries --
# Free functions, not methods: tools/metrics_dump.py --delta and the
# capacity model run the same selection/percentile math over snapshots
# that never lived in a ring (offline JSONL files).

def match_series(metrics, name, labels=None):
    """Series records of metric ``name`` whose labels contain every
    pair in ``labels`` (subset match, values compared as strings).
    ``metrics`` is one ``MetricsRegistry.snapshot()`` dict."""
    rec = metrics.get(name)
    if rec is None:
        return []
    want = {str(k): str(v) for k, v in (labels or {}).items()}
    out = []
    for series in rec.get("series", []):
        have = series.get("labels", {})
        if all(have.get(k) == v for k, v in want.items()):
            out.append(series)
    return out


def scalar_value(metrics, name, labels=None):
    """Sum of the matching counter/gauge series (None when the metric
    or every matching series is absent). Summing is the mergeable-
    series contract: dropping a label dimension aggregates over it."""
    matched = [s for s in match_series(metrics, name, labels)
               if "value" in s]
    if not matched:
        return None
    return sum(_to_float(s["value"]) for s in matched)


def hist_collect(metrics, name, labels=None):
    """Merged ``(edges, cum_counts, sum, count)`` of the matching
    histogram series (None when absent). Fixed shared edges make the
    merge a plain element-wise sum — the registry's design reason for
    refusing adaptive buckets."""
    matched = [s for s in match_series(metrics, name, labels)
               if "counts" in s]
    if not matched:
        return None
    edges = tuple(matched[0]["buckets"])
    cums = [0] * len(matched[0]["counts"])
    total_sum, total_count = 0.0, 0
    for s in matched:
        if tuple(s["buckets"]) != edges:
            raise ValueError(
                f"histogram {name!r}: cannot merge series with "
                "different bucket edges")
        for i, c in enumerate(s["counts"]):
            cums[i] += c
        total_sum += _to_float(s["sum"])
        total_count += s["count"]
    return edges, cums, total_sum, total_count


def diff_cum_counts(cums_then, cums_now):
    """Window delta of two cumulative bucket-count vectors (now -
    then), clamped reset-aware: a counter that went backwards (process
    restart) contributes its full current value, the Prometheus
    ``rate()`` convention."""
    if len(cums_then) != len(cums_now):
        raise ValueError("bucket-count length mismatch")
    if cums_now[-1] < cums_then[-1]:        # reset: restart from zero
        return list(cums_now)
    return [max(0, n - t) for t, n in zip(cums_then, cums_now)]


def percentile_from_counts(edges, cum_counts, p):
    """Quantile estimate from cumulative fixed-edge bucket counts by
    linear interpolation inside the target bucket (same estimator as
    ``HistogramChild.percentile``, minus the observed min/max clamp a
    delta window cannot know). The +Inf overflow bucket clamps to the
    top edge. Returns None for an empty window."""
    total = cum_counts[-1]
    if total <= 0:
        return None
    rank = (p / 100.0) * total
    prev_cum = 0
    for i, cum in enumerate(cum_counts):
        if cum >= rank and cum > prev_cum:
            lo = edges[i - 1] if i > 0 else 0.0
            hi = edges[i] if i < len(edges) else edges[-1]
            frac = (rank - prev_cum) / (cum - prev_cum)
            return lo + (hi - lo) * max(0.0, min(1.0, frac))
        prev_cum = cum
    return edges[-1]


class TimeSeriesRing:
    """Bounded ring of timestamped registry snapshots + delta queries.

    ``record()`` appends one ``{ts, metrics}`` record (explicitly, or
    periodically via :meth:`start`); queries pick the newest record
    and the oldest record inside the trailing window and compute the
    delta between them. Capacity: constructor arg >
    ``MXNET_TPU_TS_RING`` env (default 512) — a 1s cadence ring of 512
    covers ~8.5 minutes of history in bounded memory.
    """

    def __init__(self, registry=None, capacity=None):
        if registry is None:
            from .registry import get_registry
            registry = get_registry()
        self._registry = registry
        self.capacity = int(capacity) if capacity else _env_ring()
        if self.capacity < 2:
            raise ValueError("ring needs capacity >= 2 (deltas take "
                             "two snapshots)")
        self._ring = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._recorder = None
        self._stop = threading.Event()
        self._snaps = registry.counter(
            "mxtpu_ts_snapshots_total",
            "Registry snapshots recorded into the time-series ring.")
        self._dropped = registry.counter(
            "mxtpu_ts_snapshots_dropped_total",
            "Ring-evicted snapshots (capacity bound; raise "
            "MXNET_TPU_TS_RING for longer history).")
        self._size = registry.gauge(
            "mxtpu_ts_ring_size",
            "Snapshots currently held by the time-series ring.")

    # ------------------------------------------------------ recording --
    def record(self, now=None):
        """Snapshot the registry into the ring; returns the record."""
        rec = {"ts": time.monotonic() if now is None else float(now),
               "metrics": self._registry.snapshot()}
        with self._lock:
            evict = len(self._ring) == self.capacity
            self._ring.append(rec)
            size = len(self._ring)
        self._snaps.inc()
        if evict:
            self._dropped.inc()
        self._size.set(size)
        return rec

    def start(self, interval_s=1.0):
        """Record every ``interval_s`` seconds from a daemon thread
        until :meth:`stop` — the periodic mode an autoscaling signal
        source runs in. Idempotent while running."""
        if self._recorder is not None and self._recorder.is_alive():
            return self
        self._stop.clear()
        interval_s = max(0.01, float(interval_s))

        def _loop():
            while not self._stop.wait(interval_s):
                self.record()

        self._recorder = threading.Thread(
            target=_loop, name="mxtpu-ts-recorder", daemon=True)
        self._recorder.start()
        return self

    def stop(self):
        self._stop.set()
        if self._recorder is not None:
            self._recorder.join(timeout=5)
            self._recorder = None

    # -------------------------------------------------------- access --
    def __len__(self):
        with self._lock:
            return len(self._ring)

    def records(self):
        with self._lock:
            return list(self._ring)

    def latest(self):
        with self._lock:
            return self._ring[-1] if self._ring else None

    def span_s(self):
        """Seconds between the oldest and newest snapshot (0 with <2)."""
        with self._lock:
            if len(self._ring) < 2:
                return 0.0
            return self._ring[-1]["ts"] - self._ring[0]["ts"]

    def bounds(self, window_s=None, now=None):
        """The ``(then, now)`` record pair a trailing-window delta is
        computed over: the newest record, and the oldest record whose
        ts >= now - window (the whole ring when ``window_s`` is None).
        None when fewer than two snapshots qualify."""
        with self._lock:
            if len(self._ring) < 2:
                return None
            newest = self._ring[-1]
            if window_s is None:
                return self._ring[0], newest
            cutoff = (newest["ts"] if now is None else float(now)) \
                - float(window_s)
            for rec in self._ring:
                if rec["ts"] >= cutoff:
                    if rec is newest:
                        return None
                    return rec, newest
            return None

    # ------------------------------------------------------- queries --
    def delta(self, name, labels=None, window_s=None):
        """Counter increase over the window (reset-aware; None when
        the metric is missing or the window holds <2 snapshots)."""
        b = self.bounds(window_s)
        if b is None:
            return None
        then, now = b
        v_now = scalar_value(now["metrics"], name, labels)
        if v_now is None:
            return None
        v_then = scalar_value(then["metrics"], name, labels) or 0.0
        if v_now < v_then:          # reset: restart from zero
            return v_now
        return v_now - v_then

    def rate(self, name, labels=None, window_s=None):
        """Per-second counter increase over the trailing window — the
        in-process ``rate()``. For histograms use :meth:`hist_delta`
        instead. Reads ONE bounds() pair for both the delta and its
        dt, so a concurrent recorder tick cannot mismatch them."""
        b = self.bounds(window_s)
        if b is None:
            return None
        then, now = b
        dt = now["ts"] - then["ts"]
        if dt <= 0:
            return None
        v_now = scalar_value(now["metrics"], name, labels)
        if v_now is None:
            return None
        v_then = scalar_value(then["metrics"], name, labels) or 0.0
        d = v_now if v_now < v_then else v_now - v_then   # reset-aware
        return d / dt

    def hist_delta(self, name, labels=None, window_s=None):
        """Windowed histogram delta: ``(edges, cum_counts, sum, count,
        dt_s)`` of only the observations inside the window (None when
        absent or <2 snapshots)."""
        b = self.bounds(window_s)
        if b is None:
            return None
        then, now = b
        h_now = hist_collect(now["metrics"], name, labels)
        if h_now is None:
            return None
        edges, cums_now, sum_now, count_now = h_now
        h_then = hist_collect(then["metrics"], name, labels)
        if h_then is None:
            cums, dsum, dcount = list(cums_now), sum_now, count_now
        else:
            _, cums_then, sum_then, count_then = h_then
            cums = diff_cum_counts(cums_then, cums_now)
            if count_now < count_then:          # reset
                dsum, dcount = sum_now, count_now
            else:
                dsum = sum_now - sum_then
                dcount = count_now - count_then
        return edges, cums, dsum, dcount, now["ts"] - then["ts"]

    def percentile_over(self, name, p, labels=None, window_s=None):
        """Histogram percentile over ONLY the window's observations
        (None when empty) — a fresh latency regression shows here
        while the cumulative percentile still averages it away."""
        h = self.hist_delta(name, labels, window_s)
        if h is None:
            return None
        edges, cums, _, _, _ = h
        return percentile_from_counts(edges, cums, p)

    def series(self, name, labels=None):
        """``(ts, value)`` per snapshot for a scalar metric (gaps
        skipped) — raw material for plots/export."""
        out = []
        for rec in self.records():
            v = scalar_value(rec["metrics"], name, labels)
            if v is not None:
                out.append((rec["ts"], v))
        return out

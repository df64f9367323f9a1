"""Process-wide metrics registry: counters, gauges, histograms (the port
of ``mxnet_tpu/observability/registry.py``).

The quantitative substrate every subsystem reports through (naming
scheme ``mxtpu_<subsystem>_<metric>``): training step timing, serving
latency, decode serving, the tracer and the flight recorder all land in
ONE registry with ONE exposition so a single scrape (or JSONL snapshot)
shows the whole process.

Design rules:

- zero dependencies — stdlib only, importable from anywhere in the
  stack without cycles;
- histograms use FIXED bucket edges (chosen at creation, never
  adaptive) so per-host histograms are mergeable: summing bucket
  counts across hosts yields the pod-level distribution, which
  quantile sketches with data-dependent centroids do not;
- every mutation is thread-safe (the serving worker thread and the
  callers' submit threads write concurrently);
- two zero-dependency exporters: :meth:`MetricsRegistry.expose`
  (Prometheus text exposition, format 0.0.4) and
  :meth:`MetricsRegistry.write_snapshot` (JSON-lines, gated by
  ``MXNET_TPU_METRICS_LOG``; ``tools/metrics_dump.py`` renders it).
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import threading
import time

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "DEFAULT_TIME_BUCKETS"]

# Latency-style edges (seconds): 100us .. 60s, roughly 2.5x apart.
# Fixed for the whole process so cross-host merging stays valid.
DEFAULT_TIME_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


import math


def _fmt(v):
    """Float formatting for the exposition: integers stay integral;
    non-finite values use the Prometheus tokens (one NaN gauge — e.g. a
    diverged grad norm — must not kill the whole scrape)."""
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _json_num(v):
    """JSON-safe value: non-finite floats become the strings
    ``Infinity``/``-Infinity``/``NaN`` (which ``float()`` parses back),
    keeping write_snapshot output strict JSON."""
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    return v


def _escape_help(s):
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s):
    return (s.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


class _Child:
    """One (metric, label-values) time series."""

    def __init__(self, parent, labelvalues):
        self._parent = parent
        self._lock = parent._lock
        self.labelvalues = labelvalues

    @property
    def labels_dict(self):
        return dict(zip(self._parent.labelnames, self.labelvalues))


class CounterChild(_Child):
    def __init__(self, parent, labelvalues):
        super().__init__(parent, labelvalues)
        self._value = 0.0

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = 0.0


class GaugeChild(_Child):
    def __init__(self, parent, labelvalues):
        super().__init__(parent, labelvalues)
        self._value = 0.0

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        self.inc(-amount)

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = 0.0


class HistogramChild(_Child):
    """Fixed-edge histogram. Memory is O(len(edges)) forever — the
    bounded replacement for raw sample reservoirs (opt-in bucket
    exemplars are capped per bucket, see :mod:`.exemplars`)."""

    def __init__(self, parent, labelvalues):
        super().__init__(parent, labelvalues)
        n = len(parent.buckets)
        self._counts = [0] * (n + 1)   # last slot = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._min = None
        self._max = None
        self._exemplars = None         # {bucket_i: deque} once seen

    def observe(self, value, exemplar=None):
        """Record one observation. ``exemplar`` (optional) is a
        ``(req, span_id)`` pair kept in the landing bucket's bounded
        last-K reservoir — the flight-recorder join from a latency
        bucket to the request that filled it. ``None`` (the default)
        costs one test: no allocation rides the unexemplared path."""
        value = float(value)
        i = bisect.bisect_left(self._parent.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value
            if exemplar is not None:
                ex = self._exemplars
                if ex is None:
                    ex = self._exemplars = {}
                lst = ex.get(i)
                if lst is None:
                    from .exemplars import EXEMPLARS_PER_BUCKET
                    lst = ex[i] = collections.deque(
                        maxlen=EXEMPLARS_PER_BUCKET)
                lst.append((value, exemplar[0], exemplar[1],
                            time.time()))

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def percentile(self, p):
        """Quantile estimate by linear interpolation inside the bucket
        holding the target rank. Monotone in ``p`` by construction; the
        open-ended tail is clamped to the observed max so a single huge
        outlier cannot report +Inf."""
        with self._lock:
            total = self._count
            if total == 0:
                return 0.0
            rank = (p / 100.0) * total
            edges = self._parent.buckets
            cum = 0
            est = self._max if self._max is not None else 0.0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                lo = edges[i - 1] if i > 0 else (
                    self._min if self._min is not None else 0.0)
                hi = edges[i] if i < len(edges) else (
                    self._max if self._max is not None else lo)
                lo = min(lo, hi)
                if cum + c >= rank:
                    frac = (rank - cum) / c
                    est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                    break
                cum += c
            # interpolation can overshoot what was actually seen when
            # samples cluster just past a bucket edge; the observed
            # range is authoritative
            if self._min is not None:
                est = max(est, self._min)
            if self._max is not None:
                est = min(est, self._max)
            return est

    def bucket_counts(self):
        """Cumulative counts per edge (Prometheus ``le`` semantics),
        ending with the +Inf total."""
        with self._lock:
            out = []
            cum = 0
            for c in self._counts:
                cum += c
                out.append(cum)
            return out

    def collect(self):
        """(bucket_counts, sum, count) read under ONE lock hold, so a
        concurrent observe() cannot tear an exposition/snapshot (the
        +Inf bucket must always equal the count)."""
        with self._lock:
            return self.bucket_counts(), self._sum, self._count

    def reset(self):
        with self._lock:
            self._counts = [0] * len(self._counts)
            self._sum = 0.0
            self._count = 0
            self._min = None
            self._max = None
            self._exemplars = None


class _Metric:
    """Parent: owns the label children. A metric declared with no
    labelnames is its own single child."""

    child_cls = None
    type_name = None

    def __init__(self, name, help="", labelnames=(), lock=None, **kw):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock or threading.RLock()
        self._children = {}
        self._kw = kw
        if not self.labelnames:
            self._default = self._make_child(())
        else:
            self._default = None

    def _make_child(self, labelvalues):
        child = self.child_cls(self, labelvalues)
        self._children[labelvalues] = child
        return child

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass labels positionally or by name, "
                                 "not both")
            if set(kv) != set(self.labelnames):
                raise ValueError(
                    f"{self.name}: expected labels "
                    f"{sorted(self.labelnames)}, got {sorted(kv)}")
            values = tuple(str(kv[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child(values)
            return child

    def children(self):
        with self._lock:
            return list(self._children.values())

    def _need_default(self):
        if self._default is None:
            raise ValueError(
                f"metric {self.name} has labels {self.labelnames}; "
                "use .labels(...) first")
        return self._default

    def reset(self):
        for c in self.children():
            c.reset()


class Counter(_Metric):
    child_cls = CounterChild
    type_name = "counter"

    def inc(self, amount=1):
        self._need_default().inc(amount)

    @property
    def value(self):
        return self._need_default().value


class Gauge(_Metric):
    child_cls = GaugeChild
    type_name = "gauge"

    def set(self, value):
        self._need_default().set(value)

    def inc(self, amount=1):
        self._need_default().inc(amount)

    def dec(self, amount=1):
        self._need_default().dec(amount)

    @property
    def value(self):
        return self._need_default().value


class Histogram(_Metric):
    child_cls = HistogramChild
    type_name = "histogram"

    def __init__(self, name, help="", labelnames=(), lock=None,
                 buckets=DEFAULT_TIME_BUCKETS):
        buckets = tuple(sorted(float(b) for b in buckets))
        if not buckets:
            raise ValueError("histogram needs at least one bucket edge")
        self.buckets = buckets
        super().__init__(name, help, labelnames, lock)

    def observe(self, value, exemplar=None):
        self._need_default().observe(value, exemplar=exemplar)

    def percentile(self, p):
        return self._need_default().percentile(p)

    @property
    def count(self):
        return self._need_default().count

    @property
    def sum(self):
        return self._need_default().sum


class MetricsRegistry:
    """Named collection of metrics with get-or-create semantics.

    ``counter``/``gauge``/``histogram`` are idempotent: calling twice
    with the same name returns the same object, so instrumentation
    sites scattered across the stack need no shared setup. Re-declaring
    a name as a different type (or a histogram with different edges)
    raises — silent divergence would corrupt the exposition.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics = {}
        self._write_lock = threading.Lock()

    # ------------------------------------------------------ declaration --
    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.type_name}, not {cls.type_name}")
                if tuple(labelnames) != m.labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{m.labelnames}, not {tuple(labelnames)}")
                if kw.get("buckets") is not None and \
                        tuple(sorted(float(b) for b in kw["buckets"])) \
                        != m.buckets:
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        "different bucket edges")
                if help and not m.help:
                    m.help = help
                return m
            if cls is Histogram and kw.get("buckets") is None:
                kw.pop("buckets", None)
            m = cls(name, help, labelnames, lock=self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()):
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=None):
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def metrics(self):
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def reset(self):
        """Zero every series (test isolation; a production scrape never
        needs this — counters are cumulative by contract)."""
        for m in self.metrics():
            m.reset()

    # ------------------------------------------------------- exporters --
    def expose(self):
        """Prometheus text exposition (format 0.0.4) of every metric."""
        lines = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.type_name}")
            for child in m.children():
                base = dict(zip(m.labelnames, child.labelvalues))
                if isinstance(m, Histogram):
                    cums, hsum, hcount = child.collect()
                    for edge, cum in zip(m.buckets, cums):
                        lines.append(self._sample(
                            m.name + "_bucket",
                            dict(base, le=("%.12g" % edge)), cum))
                    lines.append(self._sample(
                        m.name + "_bucket", dict(base, le="+Inf"),
                        cums[-1]))
                    lines.append(self._sample(m.name + "_sum", base,
                                              hsum))
                    lines.append(self._sample(m.name + "_count", base,
                                              hcount))
                else:
                    lines.append(self._sample(m.name, base, child.value))
        return "\n".join(lines) + "\n"

    @staticmethod
    def _sample(name, labels, value):
        if labels:
            body = ",".join(f'{k}="{_escape_label(str(v))}"'
                            for k, v in labels.items())
            return f"{name}{{{body}}} {_fmt(value)}"
        return f"{name} {_fmt(value)}"

    def snapshot(self):
        """JSON-friendly dump: {name: {type, help, [labelnames,] series}}
        where each series carries its label values and either ``value``
        or (for histograms) ``buckets``/``counts``/``sum``/``count``."""
        out = {}
        for m in self.metrics():
            series = []
            for child in m.children():
                rec = {"labels": child.labels_dict}
                if isinstance(m, Histogram):
                    cums, hsum, hcount = child.collect()
                    rec["buckets"] = list(m.buckets)
                    rec["counts"] = cums
                    rec["sum"] = _json_num(hsum)
                    rec["count"] = hcount
                else:
                    rec["value"] = _json_num(child.value)
                series.append(rec)
            out[m.name] = {"type": m.type_name, "help": m.help,
                           "series": series}
        return out

    def write_snapshot(self, path=None):
        """Append one JSONL snapshot line. ``path`` defaults to
        ``MXNET_TPU_METRICS_LOG``; with neither set this is a no-op, so
        call sites need no guards. Returns the path written (or None)."""
        path = path or os.environ.get("MXNET_TPU_METRICS_LOG")
        if not path:
            return None
        rec = {"ts": time.time(), "metrics": self.snapshot()}
        # allow_nan=False: snapshot() stringifies non-finite floats, so
        # anything that would emit bare NaN/Infinity is a bug
        line = (json.dumps(rec, sort_keys=True, allow_nan=False)
                + "\n").encode()
        # serialize appenders (interval daemon, atexit hook, explicit
        # calls) and land each snapshot in ONE os-level write — lines
        # larger than the stdio buffer would otherwise interleave and
        # corrupt the JSONL for every downstream reader
        with self._write_lock:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                         0o644)
            try:
                os.write(fd, line)
            finally:
                os.close(fd)
        return path


_global = None
_global_lock = threading.Lock()


def get_registry():
    """The process-wide registry every built-in instrumentation site
    reports to. Created on first use; when ``MXNET_TPU_METRICS_LOG`` is
    set, a final snapshot is appended at interpreter exit (plus every
    ``MXNET_TPU_METRICS_INTERVAL`` seconds from a daemon thread)."""
    global _global
    with _global_lock:
        if _global is None:
            _global = MetricsRegistry()
            try:
                _start_env_exporters(_global)
            except Exception as exc:
                # a malformed optional env var must never take down the
                # instrumented hot path (Trainer.step etc.) that asked
                # for the registry
                import warnings
                warnings.warn(
                    f"MXNET_TPU_METRICS_* exporter setup failed: {exc!r}")
        return _global


def _start_env_exporters(reg):
    if not os.environ.get("MXNET_TPU_METRICS_LOG"):
        return
    import atexit
    atexit.register(lambda: _safe_write(reg))
    try:
        interval = float(
            os.environ.get("MXNET_TPU_METRICS_INTERVAL", 0) or 0)
    except ValueError:
        import warnings
        warnings.warn(
            "MXNET_TPU_METRICS_INTERVAL=%r is not a number of seconds; "
            "periodic snapshots disabled (at-exit snapshot still on)"
            % os.environ.get("MXNET_TPU_METRICS_INTERVAL"))
        interval = 0.0
    if interval > 0:
        def _loop():
            while True:
                time.sleep(interval)
                _safe_write(reg)
        threading.Thread(target=_loop, name="mxtpu-metrics-writer",
                         daemon=True).start()


def _safe_write(reg):
    try:
        reg.write_snapshot()
    except Exception:
        pass

"""Declarative serving SLOs evaluated from registry snapshots (a copy of
``mxnet_tpu/observability/slo.py``; the ``slo`` trigger dumps through
the port's flight recorder).

An SLO here is the standard good-events-over-total-events objective
("99% of requests complete under 100ms", "99.9% of submitted requests
are served"), declared once and evaluated mechanically from the same
``MetricsRegistry.snapshot()`` dicts every exporter already produces —
no new instrumentation, no sampling path of its own. Three shapes
cover the serving stack:

- :meth:`SLO.latency` — fraction of requests under a latency bound,
  from any fixed-edge histogram (the bound snaps to the nearest bucket
  edge, where the count is exact — no interpolation error in the SLI);
- :meth:`SLO.ttft` — the same, defaulted onto the LLM
  time-to-first-token histogram (the interactive-decode objective);
- :meth:`SLO.availability` — good counters over good+bad counters;
  :meth:`SLO.serving_availability` / :meth:`SLO.llm_availability`
  pre-wire the reference's definition served/(served+shed+expired) for the
  two front ends.

**Burn rate** is how fast the error budget (1 - target) is being
spent: ``burn = windowed_error_rate / (1 - target)``; 1.0 spends the
budget exactly at the rate the objective affords, N spends it N times
faster. :class:`SLOEngine` evaluates each SLO's burn over MULTIPLE
trailing windows from a :class:`~.timeseries.TimeSeriesRing` (the
Google SRE workbook's multi-window multi-burn-rate alerting: a long
window to be sure, a short window paired with it to reset fast once
the problem stops). Status ladder, highest wins:

====== ===== ========================================================
status value meaning
====== ===== ========================================================
OK     0     attainment >= target, no window burning hot
WARN   1     slow-burn pair tripped (budget gone in days, not hours)
PAGE   2     fast-burn pair tripped (budget burning away NOW)
BREACH 3     cumulative attainment is below target — the objective
             itself is violated, not merely trending toward it
====== ===== ========================================================

Every evaluation publishes ``mxtpu_slo_attainment{slo=}``,
``mxtpu_slo_error_budget_remaining{slo=}``,
``mxtpu_slo_burn_rate{slo=,window=}`` and ``mxtpu_slo_status{slo=}``
back onto the registry, so SLO state rides the same exposition as the
metrics it was derived from. ``tools/load_replay.py`` drives this
against replayed traffic and :mod:`.capacity` turns the result into a
committed capacity report.

Env knobs (evaluation-time, never per-SLO): ``MXNET_TPU_SLO_WINDOWS``
(``"long:short,long:short"`` seconds, default ``"60:5,300:30"`` —
replay-scaled, not the workbook's hours),
``MXNET_TPU_SLO_FAST_BURN`` (default 14.4) and
``MXNET_TPU_SLO_SLOW_BURN`` (default 6.0).
"""
from __future__ import annotations

import os

from .timeseries import hist_collect, scalar_value

__all__ = ["SLO", "SLOEngine", "default_windows", "burn_thresholds",
           "STATUS_OK", "STATUS_WARN", "STATUS_PAGE", "STATUS_BREACH",
           "STATUS_NAMES"]

STATUS_OK = 0
STATUS_WARN = 1
STATUS_PAGE = 2
STATUS_BREACH = 3
STATUS_NAMES = {STATUS_OK: "ok", STATUS_WARN: "warn",
                STATUS_PAGE: "page", STATUS_BREACH: "breach"}

_DEF_FAST_BURN = 14.4       # 2% of a 30d budget in 1h, the classic pair
_DEF_SLOW_BURN = 6.0        # 10% of a 30d budget in 6h


def _env_float(name, default):
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        import warnings
        warnings.warn(f"{name}={v!r} is not a number; using {default}")
        return default


def burn_thresholds():
    """``(fast, slow)`` burn-rate thresholds, env-overridable — the
    one lookup every window maker (here and replay-scaled ones like
    ``tools/load_replay.py``'s) must share."""
    return (_env_float("MXNET_TPU_SLO_FAST_BURN", _DEF_FAST_BURN),
            _env_float("MXNET_TPU_SLO_SLOW_BURN", _DEF_SLOW_BURN))


def default_windows():
    """The multi-window burn-rate ladder: ``[(long_s, short_s,
    burn_threshold, status), ...]``, fast pair first. Windows come
    from ``MXNET_TPU_SLO_WINDOWS`` (``"long:short,long:short"``),
    thresholds from ``MXNET_TPU_SLO_{FAST,SLOW}_BURN``; extra window
    pairs beyond two reuse the slow-burn threshold."""
    fast, slow = burn_thresholds()
    spec = os.environ.get("MXNET_TPU_SLO_WINDOWS", "60:5,300:30")
    out = []
    for i, pair in enumerate(p for p in spec.split(",") if p.strip()):
        try:
            long_s, short_s = (float(x) for x in pair.split(":"))
        except ValueError:
            import warnings
            warnings.warn(f"MXNET_TPU_SLO_WINDOWS pair {pair!r} is not "
                          "'long:short' seconds; skipped")
            continue
        thr = fast if i == 0 else slow
        status = STATUS_PAGE if i == 0 else STATUS_WARN
        out.append((long_s, short_s, thr, status))
    return out or [(60.0, 5.0, fast, STATUS_PAGE),
                   (300.0, 30.0, slow, STATUS_WARN)]


class SLO:
    """One declarative objective: a name, a target fraction, and a way
    to read ``(good, total)`` out of a registry snapshot."""

    def __init__(self, name, kind, target, good=(), bad=(),
                 histogram=None, labels=None, threshold_s=None,
                 description=""):
        if not (0.0 < float(target) < 1.0):
            raise ValueError(
                f"SLO {name!r}: target must be in (0, 1), got {target} "
                "(a target of 1.0 leaves no error budget to burn)")
        if kind not in ("latency", "availability"):
            raise ValueError(f"SLO {name!r}: unknown kind {kind!r}")
        self.name = str(name)
        self.kind = kind
        self.target = float(target)
        self.good = tuple(good)          # [(metric, labels), ...]
        self.bad = tuple(bad)
        self.histogram = histogram
        self.labels = dict(labels or {})
        self.threshold_s = threshold_s
        # the edge the threshold actually lands on (set per snapshot;
        # exact bucket counts beat an interpolated SLI)
        self.effective_threshold_s = None
        self.description = description

    # ------------------------------------------------- constructors --
    @classmethod
    def latency(cls, name, threshold_ms, target=0.99,
                histogram="mxtpu_serving_latency_seconds", labels=None):
        """Fraction of requests at or under ``threshold_ms`` >=
        ``target``, from a fixed-edge latency histogram."""
        return cls(name, "latency", target, histogram=histogram,
                   labels=labels, threshold_s=float(threshold_ms) / 1e3,
                   description=f"p{target * 100:g} of requests <= "
                               f"{threshold_ms:g}ms")

    @classmethod
    def ttft(cls, name, threshold_ms, target=0.9, labels=None):
        """Time-to-first-token objective for the LLM front end."""
        slo = cls.latency(name, threshold_ms, target,
                          histogram="mxtpu_llm_ttft_seconds",
                          labels=labels)
        slo.description = (f"p{target * 100:g} of generations reach "
                           f"first token <= {threshold_ms:g}ms")
        return slo

    @classmethod
    def availability(cls, name, good, bad, target=0.999,
                     description=""):
        """good/(good+bad) >= target over counter selectors
        ``[(metric_name, labels), ...]``."""
        return cls(name, "availability", target, good=good, bad=bad,
                   description=description or
                   f"{target * 100:g}% of requests served")

    @classmethod
    def serving_availability(cls, name, server, target=0.999):
        """The reference's definition for the single-shot front end:
        served / (served + shed + deadline-expired)."""
        lbl = {"server": server}
        return cls.availability(
            name,
            good=[("mxtpu_serving_requests_completed_total", lbl)],
            bad=[("mxtpu_serving_shed_total", lbl),
                 ("mxtpu_serving_deadline_expired_total", lbl)],
            target=target,
            description="served/(served+shed+expired) for server="
                        + str(server))

    @classmethod
    def llm_availability(cls, name, server, target=0.999):
        """The decode front end's partition: full generations over
        full + shed + deadline-expired + evicted (an eviction is a
        partial answer — bad by this objective's definition)."""
        lbl = {"server": server}
        return cls.availability(
            name,
            good=[("mxtpu_llm_requests_completed_total", lbl)],
            bad=[("mxtpu_serving_shed_total", lbl),
                 ("mxtpu_serving_deadline_expired_total", lbl),
                 ("mxtpu_llm_requests_evicted_total", lbl)],
            target=target,
            description="served/(served+shed+expired+evicted) for "
                        "llm server=" + str(server))

    # -------------------------------------------------- SLI reading --
    def _latency_good_total(self, metrics):
        h = hist_collect(metrics, self.histogram, self.labels)
        if h is None:
            return None
        edges, cums, _, count = h
        if self.threshold_s >= edges[-1]:
            # bound at/above the top finite edge: every observation —
            # including the +Inf overflow bucket — is inside it (the
            # nearest-edge snap would otherwise count overflow
            # observations as violations and report a spurious breach)
            self.effective_threshold_s = self.threshold_s
            return float(count), float(count)
        i = min(range(len(edges)),
                key=lambda j: abs(edges[j] - self.threshold_s))
        self.effective_threshold_s = edges[i]
        return float(cums[i]), float(count)

    def _avail_good_total(self, metrics):
        vals = [scalar_value(metrics, m, lbl) for m, lbl in self.good]
        if all(v is None for v in vals):
            return None
        good = sum(v for v in vals if v is not None)
        bad = sum(scalar_value(metrics, m, lbl) or 0.0
                  for m, lbl in self.bad)
        return good, good + bad

    def good_total(self, metrics):
        """``(good, total)`` events since process start, from one
        snapshot's ``metrics`` dict; None when the underlying series
        do not exist (nothing instrumented yet)."""
        if self.kind == "latency":
            return self._latency_good_total(metrics)
        return self._avail_good_total(metrics)

    def burn(self, ring, window_s):
        """Error-budget burn rate over the trailing window: windowed
        error rate / (1 - target). None when the window holds no
        events (an idle window burns nothing)."""
        b = ring.bounds(window_s)
        if b is None:
            return None
        then, now = b
        gt_now = self.good_total(now["metrics"])
        if gt_now is None:
            return None
        gt_then = self.good_total(then["metrics"]) or (0.0, 0.0)
        d_good = max(0.0, gt_now[0] - gt_then[0])
        d_total = max(0.0, gt_now[1] - gt_then[1])
        if gt_now[1] < gt_then[1]:          # reset
            d_good, d_total = gt_now
        if d_total <= 0:
            return None
        err = (d_total - d_good) / d_total
        return err / (1.0 - self.target)

    def __repr__(self):
        return (f"SLO({self.name!r}, {self.kind}, "
                f"target={self.target:g})")


class SLOEngine:
    """Evaluate a set of SLOs against a snapshot ring and publish the
    result back onto the registry (``mxtpu_slo_*``)."""

    def __init__(self, slos, ring, registry=None, windows=None,
                 publish=True):
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.slos = list(slos)
        self.ring = ring
        self.windows = list(windows) if windows is not None \
            else default_windows()
        if registry is None:
            from .registry import get_registry
            registry = get_registry()
        self._publish = publish
        self._attain = registry.gauge(
            "mxtpu_slo_attainment",
            "Cumulative SLO attainment: good events / total events "
            "(1.0 before any traffic).", ("slo",))
        self._budget = registry.gauge(
            "mxtpu_slo_error_budget_remaining",
            "Fraction of the SLO's error budget still unspent "
            "(negative = breached).", ("slo",))
        self._burn = registry.gauge(
            "mxtpu_slo_burn_rate",
            "Error-budget burn rate over the trailing window "
            "(1.0 = spending exactly the budgeted rate).",
            ("slo", "window"))
        self._status = registry.gauge(
            "mxtpu_slo_status",
            "SLO status ladder: 0 ok, 1 warn (slow burn), 2 page "
            "(fast burn), 3 breach (attainment below target).",
            ("slo",))
        self._evals = registry.counter(
            "mxtpu_slo_evaluations_total",
            "SLOEngine.evaluate() passes.")
        # previous status per SLO: the flight recorder dumps on the
        # TRANSITION into page/breach, not on every hot evaluation
        self._prev_status = {}

    def evaluate(self, metrics=None):
        """One evaluation pass over every SLO. ``metrics`` defaults to
        the ring's newest snapshot (attainment and burn then read the
        same instant). Returns ``{slo_name: report_dict}``; each
        report is JSON-ready (the capacity model embeds it
        verbatim)."""
        if metrics is None:
            latest = self.ring.latest()
            metrics = latest["metrics"] if latest else {}
        reports = {}
        for slo in self.slos:
            gt = slo.good_total(metrics)
            good, total = gt if gt is not None else (0.0, 0.0)
            attainment = (good / total) if total > 0 else 1.0
            err = 1.0 - attainment
            budget_remaining = 1.0 - err / (1.0 - slo.target)
            status = STATUS_OK
            if total > 0 and attainment < slo.target:
                status = STATUS_BREACH
            burns = {}
            for long_s, short_s, thr, win_status in self.windows:
                b_long = slo.burn(self.ring, long_s)
                b_short = slo.burn(self.ring, short_s)
                burns[f"{long_s:g}s"] = b_long
                burns[f"{short_s:g}s"] = b_short
                if (status < win_status
                        and b_long is not None and b_long >= thr
                        and b_short is not None and b_short >= thr):
                    status = win_status
            rep = {
                "name": slo.name,
                "kind": slo.kind,
                "description": slo.description,
                "target": slo.target,
                "good": good,
                "total": total,
                "attainment": attainment,
                "error_budget_remaining": budget_remaining,
                "burn_rates": burns,
                "status": status,
                "status_name": STATUS_NAMES[status],
            }
            if slo.kind == "latency":
                rep["threshold_ms"] = (slo.threshold_s or 0.0) * 1e3
                if slo.effective_threshold_s is not None:
                    rep["effective_threshold_ms"] = \
                        slo.effective_threshold_s * 1e3
            reports[slo.name] = rep
            if self._publish:
                self._attain.labels(slo=slo.name).set(attainment)
                self._budget.labels(slo=slo.name).set(budget_remaining)
                self._status.labels(slo=slo.name).set(status)
                for win, b in burns.items():
                    # an idle window burns nothing: publish 0 so a
                    # previously-hot gauge cannot read as a live page
                    # condition after traffic stops (the report dict
                    # keeps the honest None)
                    self._burn.labels(slo=slo.name,
                                      window=win).set(b or 0.0)
        self._evals.inc()
        # flight-recorder trigger: an SLO whose status ENTERED
        # page/breach this pass dumps one post-mortem bundle carrying
        # these reports (burn windows included). Edge-triggered on the
        # transition — a breach that stays breached across evaluations
        # fires once, not per pass.
        fired = [name for name, rep in reports.items()
                 if rep["status"] >= STATUS_PAGE
                 and self._prev_status.get(name,
                                           STATUS_OK) < STATUS_PAGE]
        self._prev_status = {name: rep["status"]
                             for name, rep in reports.items()}
        if fired:
            from .flightrecorder import get_flightrecorder
            recorder = get_flightrecorder()
            if recorder.enabled:
                for name in fired:
                    recorder.event("slo.trigger", attrs={
                        "slo": name,
                        "status": reports[name]["status_name"]})
                recorder.slo_dump(fired, reports)
        return reports

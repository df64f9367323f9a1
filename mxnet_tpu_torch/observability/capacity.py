"""Committed capacity model: chips per million users at a declared SLO
(the port of ``mxnet_tpu/observability/capacity.py``).

The north-star question ("how many chips does M users take?") is an
*observability-derived* artifact, not a marketing number: every input
here is read back out of registry snapshots recorded while
``tools/load_replay.py`` drove realistic traffic at the servers —
served/shed/expired counters, token counters, latency histograms, the
SLO engine's attainment/status — never hand-entered. The only declared
inputs are the per-user demand assumptions (how many requests and
tokens one user generates per second), and the report carries them
verbatim so a reader can re-derive every number.

Derivation per front end (over the replay window, oldest→newest ring
snapshot):

- ``served_qps`` / ``tokens_per_sec`` — counter deltas / elapsed;
- ``good_qps`` — the rate of requests that ALSO met the latency SLO
  (the latency SLO's good-bucket count delta / elapsed): the rate the
  service sustained *at* the objective, which is what "sustainable"
  means — a server can always serve more requests late;
- ``*_per_chip`` — divided by the chip count the replay ran on;
- ``chips_per_m_users`` — 1e6 x per-user demand / per-chip
  sustainable rate (requests for the single-shot front end, tokens
  for decode). The headline is the sum over front ends: each needs
  its own chips.

``slo_attained`` is the AND over every SLO's non-breach status. When
false, the report still carries the measured rates but marks them
``"over capacity"`` — the run demanded more than the SLO affords, so
the sustainable rate is an upper bound read from the good-rate, not a
proof.

The port's report also names the card the window ran on (``device``:
the caller's, else ``torch.cuda.get_device_name(0)`` when torch is
loaded and a card is present, else ``"cpu"``), and its declared HBM
budget is an H100's 80 GB.
"""
from __future__ import annotations

import sys

__all__ = ["DEFAULT_USER_MODEL", "DEFAULT_HBM_MODEL",
           "FRONTEND_METRICS", "measure_frontend", "build_report",
           "device_name"]

# Declared per-user demand assumptions (config, NOT measurement — the
# report embeds them so every derived number is reproducible).
# 0.005 req/s/user ~ one request every 200s of active use; 1.5
# tokens/s/user ~ a chat turn of ~90 tokens a minute.
DEFAULT_USER_MODEL = {
    "requests_per_user_per_s": 0.005,
    "tokens_per_user_per_s": 1.5,
}

# Declared per-card HBM assumptions for the models-per-chip derivation
# (config, NOT measurement — carried verbatim in the report): an H100's
# 80 GB with half budgeted for resident weights, the other half holding
# KV pages + activations + graphs. The measured input is the server's
# device-resident weight bytes (quantized leaves + f32 scales for a
# quantized checkpoint), so ``models_per_chip = weight_budget //
# weight_bytes``.
DEFAULT_HBM_MODEL = {
    "hbm_bytes_per_chip": 80 * 10 ** 9,
    "weight_fraction": 0.5,
}

# Which registry series drive each front end's partition. "expired"
# covers both queue/decode deadline expiry; "evicted" exists only for
# decode (partial generations under drain/cancel).
FRONTEND_METRICS = {
    "serving": {
        "submitted": "mxtpu_serving_requests_submitted_total",
        "served": "mxtpu_serving_requests_completed_total",
        "shed": "mxtpu_serving_shed_total",
        "expired": "mxtpu_serving_deadline_expired_total",
        "tokens": None,
        "demand_key": "requests_per_user_per_s",
    },
    "llm": {
        "submitted": "mxtpu_llm_requests_submitted_total",
        "served": "mxtpu_llm_requests_completed_total",
        "shed": "mxtpu_serving_shed_total",
        "expired": "mxtpu_serving_deadline_expired_total",
        "evicted": "mxtpu_llm_requests_evicted_total",
        "tokens": "mxtpu_llm_tokens_generated_total",
        "demand_key": "tokens_per_user_per_s",
    },
}


def _rate(ring, name, labels):
    v = ring.rate(name, labels)
    return v if v is not None else 0.0


def measure_frontend(ring, kind, server, chips=1, latency_slo=None):
    """Measured rates for one front end over the ring's full span.

    ``latency_slo`` (an :class:`~.slo.SLO` of kind latency) supplies
    the good-rate: requests/sec that landed inside the SLO bound.
    Returns a JSON-ready dict; every rate is per second."""
    spec = FRONTEND_METRICS[kind]
    lbl = {"server": server}
    span = ring.span_s()
    out = {
        "kind": kind,
        "server": server,
        "window_s": round(span, 3),
        "submitted_qps": _rate(ring, spec["submitted"], lbl),
        "served_qps": _rate(ring, spec["served"], lbl),
        "shed_qps": _rate(ring, spec["shed"], lbl),
        "expired_qps": _rate(ring, spec["expired"], lbl),
    }
    if "evicted" in spec:
        out["evicted_qps"] = _rate(ring, spec["evicted"], lbl)
    if spec["tokens"]:
        out["tokens_per_sec"] = _rate(ring, spec["tokens"], lbl)
        out["tokens_per_sec_per_chip"] = \
            out["tokens_per_sec"] / max(1, chips)
    good_qps = None
    if latency_slo is not None:
        b = ring.bounds()
        if b is not None:
            then, now = b
            gt_now = latency_slo.good_total(now["metrics"])
            gt_then = latency_slo.good_total(then["metrics"]) \
                or (0.0, 0.0)
            dt = now["ts"] - then["ts"]
            if gt_now is not None and dt > 0:
                good_qps = max(0.0, gt_now[0] - gt_then[0]) / dt
    out["good_qps"] = good_qps if good_qps is not None \
        else out["served_qps"]
    out["qps_per_chip"] = out["good_qps"] / max(1, chips)
    return out


def device_name():
    """The card's name (``torch.cuda.get_device_name(0)``) when torch is
    loaded and a card is present, else ``"cpu"``. Reads torch from
    ``sys.modules``: this module imports nothing beyond the standard
    library."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def build_report(ring, slo_reports, frontends, chips=1,
                 user_model=None, trace=None, llm_weights=None,
                 hbm_model=None):
    """Assemble the capacity record ``perf_capture.
    emit_capacity_snapshot`` commits.

    ``frontends`` — ``[(kind, server_label, latency_slo_or_None),
    ...]`` (an optional 4th element overrides the ring for that front
    end — each replay window measures against its OWN snapshots, so a
    front end replayed later is not diluted over the other's window);
    ``slo_reports`` — the :meth:`~.slo.SLOEngine.evaluate` output;
    ``trace`` — the replay's trace spec/digest block (audit trail);
    ``llm_weights`` — the decode server's measured weight block
    (``{dtype, bytes, params_per_chip, ...}`` from its stats): when
    present the report gains a ``models_per_chip`` column derived
    under the declared ``hbm_model`` (:data:`DEFAULT_HBM_MODEL`
    overridable per key) — weight bytes are measured, the HBM budget
    is a declared assumption the report carries verbatim.
    The function never invents a value: a front end whose series are
    absent contributes nothing, and a report with no usable front end
    comes back with ``value: None`` + ``skipped`` so the emission
    contract refuses it as a headline. ``device`` names the card
    (:func:`device_name`)."""
    user_model = dict(DEFAULT_USER_MODEL, **(user_model or {}))
    chips = max(1, int(chips))
    blocks, total_chips_per_m = [], 0.0
    for entry in frontends:
        kind, server, latency_slo = entry[0], entry[1], entry[2]
        fe_ring = entry[3] if len(entry) > 3 and entry[3] is not None \
            else ring
        blk = measure_frontend(fe_ring, kind, server, chips=chips,
                               latency_slo=latency_slo)
        demand = user_model[FRONTEND_METRICS[kind]["demand_key"]]
        per_chip = (blk.get("tokens_per_sec_per_chip")
                    if FRONTEND_METRICS[kind]["tokens"]
                    else blk["qps_per_chip"])
        if per_chip and per_chip > 0:
            blk["chips_per_m_users"] = 1e6 * demand / per_chip
            total_chips_per_m += blk["chips_per_m_users"]
        else:
            blk["chips_per_m_users"] = None
        blocks.append(blk)
    statuses = [r["status_name"] for r in slo_reports.values()]
    slo_attained = bool(slo_reports) and \
        all(r["status_name"] != "breach" for r in slo_reports.values())
    usable = [b for b in blocks if b["chips_per_m_users"] is not None]
    rec = {
        "metric": "chips_per_m_users",
        "unit": "chips / 1M users",
        "value": round(total_chips_per_m, 4) if usable else None,
        "slo_attained": slo_attained,
        "slo": slo_reports,
        "slo_statuses": statuses,
        "frontends": blocks,
        "chips": chips,
        "device": device_name(),
        "user_model": user_model,
        "window_s": max([b["window_s"] for b in blocks]
                        + [round(ring.span_s(), 3)]),
        "snapshots": len(ring),
    }
    if llm_weights is not None:
        hbm = dict(DEFAULT_HBM_MODEL, **(hbm_model or {}))
        budget = hbm["hbm_bytes_per_chip"] * hbm["weight_fraction"]
        blk = dict(llm_weights)
        wb = blk.get("bytes") or 0
        blk["models_per_chip"] = int(budget // wb) if wb > 0 else None
        blk["hbm_model"] = hbm
        rec["llm_weights"] = blk
    if not usable:
        rec["skipped"] = ("no front end produced a measurable "
                          "sustained rate (empty replay window?)")
    elif not slo_attained:
        rec["detail"] = ("SLO breached during the replay window: the "
                         "sustainable rate is an upper bound read "
                         "from the in-SLO good-rate, not a proof of "
                         "capacity at the objective")
    if trace is not None:
        rec["trace"] = trace
    return rec

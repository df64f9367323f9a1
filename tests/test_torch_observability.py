"""PyTorch port, the observability modules
(``mxnet_tpu_torch/observability/{registry,exemplars,tracing,
flightrecorder}.py``) against the JAX package's, driven with the same
calls on fresh instances of each.

- the registry: the Prometheus exposition of the same counter / gauge /
  histogram operations is the same text (neither carries timestamps),
  ``tools/metrics_dump.py``'s ``parse_exposition`` reads it, the
  JSONL snapshots agree but for their ``ts``, bucket math, percentiles
  and memory stay bounded under 10k observations;
- exemplars: the same reservoirs, ``collect`` gives the same shape;
- the tracer: span nesting, the ring bound with counted drops, a Chrome
  trace both packages' ``validate_chrome_trace`` accept, the shared no-op
  span while off, and (the port's own) a ``record_function`` range on a
  running torch profiler's timeline;
- the flight recorder: the ring bound with counted drops, a bundle that
  ``tools/flight_inspect.py`` checks, and a torn dump (an injected crash
  at ``flight.dump``) that leaves data files and no manifest on both.

Pure Python on both sides: exact equality but where a value is a clock.
"""
import importlib.util
import json
import os
import sys
import threading

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch  # noqa: E402

from mxnet_tpu.observability import exemplars as jexm  # noqa: E402
from mxnet_tpu.observability import flightrecorder as jfr  # noqa: E402
from mxnet_tpu.observability import registry as jreg  # noqa: E402
from mxnet_tpu.observability import tracing as jtr  # noqa: E402
from mxnet_tpu.resilience import faults as jfaults  # noqa: E402
from mxnet_tpu_torch.observability import exemplars as texm  # noqa: E402
from mxnet_tpu_torch.observability import flightrecorder as tfr  # noqa: E402
from mxnet_tpu_torch.observability import registry as treg  # noqa: E402
from mxnet_tpu_torch.observability import tracing as ttr  # noqa: E402
from mxnet_tpu_torch.resilience import faults as tfaults  # noqa: E402
from mxnet_tpu_torch import observability as tobs  # noqa: E402

torch.set_num_threads(2)

PKGS = [(jreg, jexm, jtr, jfr, jfaults), (treg, texm, ttr, tfr, tfaults)]
IDS = ["jax", "torch"]


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_under_torch_test", os.path.join(REPO, "tools",
                                                 f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _drive_registry(reg_mod):
    """The same operations on a fresh registry of ``reg_mod``."""
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("mxtpu_t_requests_total", 'Requests "served"\n.',
                    ("server", "reason"))
    c.labels(server="a", reason="ok").inc()
    c.labels(server="a", reason="ok").inc(4)
    c.labels(server='b"x', reason="shed").inc(2.5)
    reg.counter("mxtpu_t_plain_total", "No labels.").inc(3)
    g = reg.gauge("mxtpu_t_depth", "Depth.", ("server",))
    g.labels(server="a").set(7)
    g.labels(server="a").dec(2)
    g.labels(server="b").inc(float("inf"))
    h = reg.histogram("mxtpu_t_latency_seconds", "Latency.", ("server",),
                      buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.001, 0.004, 0.05, 0.05, 0.9, 3.0):
        h.labels(server="a").observe(v, exemplar=("req:1", 11))
    reg.histogram("mxtpu_t_default_seconds", "Default edges.").observe(
        0.02)
    return reg


def test_exposition_and_snapshot_match_the_jax_registry(tmp_path):
    regs = [_drive_registry(p[0]) for p in PKGS]
    texts = [r.expose() for r in regs]
    assert texts[0] == texts[1]
    parse = _load_tool("metrics_dump").parse_exposition
    assert parse(texts[1]) == parse(texts[0])
    snaps = []
    for r, name in zip(regs, IDS):
        path = str(tmp_path / f"{name}.jsonl")
        assert r.write_snapshot(path) == path
        snap = json.loads(open(path).read())
        snap.pop("ts")
        snaps.append(snap)
    assert snaps[0] == snaps[1]
    assert treg.DEFAULT_TIME_BUCKETS == jreg.DEFAULT_TIME_BUCKETS


@pytest.mark.parametrize("pkg", range(2), ids=IDS)
def test_bucket_math_and_bounded_memory(pkg):
    reg_mod = PKGS[pkg][0]
    reg = reg_mod.MetricsRegistry()
    h = reg.histogram("t_h_seconds", "h", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.5, 3.0, 9.0):
        h.observe(v)
    child = h._need_default()
    assert child._counts == [2, 1, 1, 1]          # le is inclusive
    assert child.bucket_counts() == [2, 3, 4, 5]
    assert h.count == 5 and h.sum == pytest.approx(15.0)
    ps = [h.percentile(p) for p in (1, 25, 50, 75, 95, 99.9)]
    assert all(a <= b + 1e-12 for a, b in zip(ps, ps[1:]))
    assert 0.5 <= ps[0] and ps[-1] <= 9.0
    flat = reg.histogram("t_flat_seconds", "flat")
    fc = flat._need_default()
    flat.observe(0.01)
    size = len(fc._counts)
    for i in range(10000):
        flat.observe((i % 100) / 1000.0, exemplar=(f"r{i}", i))
    assert len(fc._counts) == size and flat.count == 10001
    held = sum(len(v) for v in PKGS[pkg][1].child_exemplars(fc).values())
    assert 0 < held <= size * PKGS[pkg][1].EXEMPLARS_PER_BUCKET


def test_percentiles_and_exemplars_match():
    regs = [_drive_registry(p[0]) for p in PKGS]
    hs = [r.get("mxtpu_t_latency_seconds").labels(server="a")
          for r in regs]
    for p in (1, 50, 90, 99, 99.9):
        assert hs[0].percentile(p) == hs[1].percentile(p)
    got = [p[1].collect(r, ("mxtpu_t_latency_seconds",))
           for p, r in zip(PKGS, regs)]
    for doc in got:                 # the wall clock of each observation
        for row in doc["mxtpu_t_latency_seconds"]:
            for exs in row["buckets"].values():
                for e in exs:
                    assert e.pop("ts_unix") > 0
    assert got[0] == got[1] and got[1]["mxtpu_t_latency_seconds"]


# ---------------------------------------------------------- the tracer --
def _drive_tracer(tr_mod, reg_mod, ring=64):
    tr = tr_mod.Tracer(ring=ring, registry=reg_mod.MetricsRegistry())
    tr.enable()
    with tr.span("outer", "step", attrs={"k": 1}, step=3) as outer:
        with tr.span("inner") as inner:
            inner.set("x", "y")
        hand = tr.begin("handoff", "llm", tr.current())
    box = []

    def worker():
        with tr.attach(outer):
            with tr.span("on_thread") as sp:
                box.append(sp.span_id)
        hand.finish()
    t = threading.Thread(target=worker, name="w")
    t.start()
    t.join(10)
    return tr


def test_span_nesting_and_chrome_trace_match():
    trs = [_drive_tracer(p[2], p[0]) for p in PKGS]
    shapes = []
    for tr in trs:
        snap = tr.snapshot()
        by = {s["name"]: s for s in snap}
        assert by["inner"]["parent_id"] == by["outer"]["span_id"]
        assert by["on_thread"]["parent_id"] == by["outer"]["span_id"]
        assert by["handoff"]["parent_id"] == by["outer"]["span_id"]
        assert by["outer"]["attrs"] == {"k": 1, "step": 3}
        shapes.append([(s["name"], s["cat"], s["thread"], s["attrs"])
                       for s in snap])
        assert tr.stats()["open"] == 0
    assert shapes[0] == shapes[1]
    for tr in trs:
        doc = tr.to_chrome_trace()
        n = sum(e["ph"] == "X" for e in doc["traceEvents"])
        assert jtr.validate_chrome_trace(doc) == n == 4
        assert ttr.validate_chrome_trace(json.dumps(doc)) == n
        # the cross-thread children draw flow arrows
        assert sum(e["ph"] in ("s", "f") for e in doc["traceEvents"]) == 2
    with pytest.raises(ValueError):
        ttr.validate_chrome_trace({"traceEvents": [{"ph": "X"}]})


@pytest.mark.parametrize("pkg", range(2), ids=IDS)
def test_tracer_ring_bounded_with_counted_drops(pkg):
    reg_mod, _, tr_mod, _, _ = PKGS[pkg]
    tr = tr_mod.Tracer(ring=256, registry=reg_mod.MetricsRegistry())
    tr.enable()
    for i in range(10000):
        tr.span(f"s{i % 7}").finish()
    st = tr.stats()
    assert (st["buffered"], st["capacity"], st["started"], st["dropped"],
            st["open"]) == (256, 256, 10000, 10000 - 256, 0)


def test_disabled_tracer_hands_out_one_noop_span():
    tr = ttr.Tracer(registry=treg.MetricsRegistry())
    assert not tr.enabled
    a, b = tr.span("hot"), tr.span("other", "step", step=3)
    assert a is b and tr.begin("handoff") is a
    with a as sp:
        sp.set("k", "v")
    assert a.finish() is None
    assert tr.stats()["started"] == 0


def test_spans_mark_a_running_torch_profiler():
    """While a torch profiler records, an activated span (tracer on) and
    the tracer-off span both open a ``record_function`` range of their
    name; hand-off spans do not."""
    tr = ttr.Tracer(registry=treg.MetricsRegistry())
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with tr.span("mxtpu.llm.step"):            # tracer off
            torch.ones(4).add_(1)
        tr.enable()
        with tr.span("mxtpu.llm.isolate"):
            torch.ones(4).mul_(2)
        tr.begin("mxtpu.llm.request").finish()
    names = {e.key for e in prof.key_averages()}
    assert {"mxtpu.llm.step", "mxtpu.llm.isolate"} <= names
    assert "mxtpu.llm.request" not in names
    assert not ttr._profiler_running()


# ------------------------------------------------- the flight recorder --
@pytest.mark.parametrize("pkg", range(2), ids=IDS)
def test_recorder_ring_bounded_with_counted_drops(pkg):
    reg_mod, _, _, fr_mod, _ = PKGS[pkg]
    fl = fr_mod.FlightRecorder(registry=reg_mod.MetricsRegistry())
    fl.event("llm.step")                           # off: records nothing
    assert fl.stats()["recorded"] == 0 and fl.snapshot() == []
    fl.enable(ring=128)
    for i in range(10_000):
        fl.event("llm.step", attrs={"i": i})
    st = fl.stats()
    assert (st["capacity"], st["buffered"], st["recorded"],
            st["dropped"]) == (128, 128, 10_000, 10_000 - 128)
    snap = fl.snapshot()
    assert snap[-1]["attrs"]["i"] == 9_999
    assert snap[0]["attrs"]["i"] == 9_999 - 127


class _Status:
    def debug_status(self):
        return {"kind": "llm", "queue_depth": 0}


@pytest.mark.parametrize("pkg", range(2), ids=IDS)
def test_bundle_checks_and_torn_dump_leaves_no_manifest(pkg, tmp_path):
    reg_mod, _, _, fr_mod, faults = PKGS[pkg]
    fi = _load_tool("flight_inspect")
    fl = fr_mod.FlightRecorder(registry=reg_mod.MetricsRegistry())
    fl.enable(out_dir=str(tmp_path))
    obj = _Status()
    fl.register("llm:t", obj)
    fl.event("llm.submit", req="llm:1", attrs={"prompt": 3})
    fl.event("llm.served", req="llm:1", attrs={"tokens": 2})
    good = fl.dump(trigger="manual", reason="ok")
    assert fi.check(good) == []
    status = json.load(open(os.path.join(good, "status.json")))
    assert status == {"llm:t": {"kind": "llm", "queue_depth": 0}}
    assert "llm.served" in fi.render_request(good, "llm:1")
    faults.reset()
    faults.crash_at_point("flight.dump", nth=1)
    try:
        with pytest.raises(faults.InjectedCrash):
            fl.dump(trigger="manual", reason="torn")
    finally:
        faults.reset()
    torn = sorted(d for d in os.listdir(tmp_path) if d != os.path.basename(
        good))
    assert len(torn) == 1
    torn = os.path.join(tmp_path, torn[0])
    assert not os.path.exists(os.path.join(torn, "MANIFEST.json"))
    assert os.path.exists(os.path.join(torn, "events.json"))
    probs = fi.check(torn)
    assert probs and any("manifest" in p.lower() for p in probs)
    # a crash dump never raises, even with the dump site armed
    faults.crash_at_point("flight.dump", nth=1)
    try:
        assert fl.crash_dump(RuntimeError("x"), server="t") is None
    finally:
        faults.reset()


def test_package_exports_only_what_is_ported():
    assert set(tobs.__all__) <= {
        "Counter", "Gauge", "Histogram", "MetricsRegistry",
        "DEFAULT_TIME_BUCKETS", "get_registry", "Span", "Tracer",
        "get_tracer", "validate_chrome_trace", "FlightRecorder",
        "get_flightrecorder", "flight_ring_capacity", "flight_triggers",
        "EXEMPLARS_PER_BUCKET"}
    assert tobs.get_registry() is treg.get_registry()
    assert tobs.get_tracer() is ttr.get_tracer()
    assert tobs.get_flightrecorder() is tfr.get_flightrecorder()
    assert treg.get_registry() is not jreg.get_registry()

"""PyTorch port, the rest of ``observability/``: the step timer, the
compile bridge, the time series, the SLOs and the capacity model
(``mxnet_tpu_torch/observability/{steptimer,compilemon,timeseries,slo,
capacity}.py``) against the JAX package's.

- the pure cases of ``tests/test_slo_capacity.py`` (the ring, the burn
  math, the status ladder, threshold snapping, the capacity algebra)
  run on the port: the module is loaded by path and its names are
  pointed at the port's classes; then the same registry operations go
  to both packages and their ``SLOEngine`` reports and capacity records
  must be equal (the port's record adds ``device``);
- the served-path cases run against the port's ``ModelServer`` beside
  the reference's, with the same counters;
- the step timer: the same series names and counts after the reference's
  two-step loop (the times differ and are not compared), and the
  estimator's default ``StepTimerHandler``;
- the compile bridge: a kernel library load and a CUDA-graph capture (the
  card's calls stubbed on the CPU) move ``mxtpu_xla_compile_total`` as
  they move ``kernels.build_count() + capture_count()``, and
  ``serving.telemetry.compile_count()`` reads the counter.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch  # noqa: E402

from mxnet_tpu import serving as jserving  # noqa: E402
from mxnet_tpu.observability import capacity as jcap  # noqa: E402
from mxnet_tpu.observability import registry as jreg  # noqa: E402
from mxnet_tpu.observability import slo as jslo  # noqa: E402
from mxnet_tpu.observability import steptimer as jst  # noqa: E402
from mxnet_tpu.observability import timeseries as jts  # noqa: E402
from mxnet_tpu.observability import tracing as jtr  # noqa: E402
from mxnet_tpu_torch import kernels, serving as tserving  # noqa: E402
from mxnet_tpu_torch.observability import capacity as tcap  # noqa: E402
from mxnet_tpu_torch.observability import compilemon  # noqa: E402
from mxnet_tpu_torch.observability import registry as treg  # noqa: E402
from mxnet_tpu_torch.observability import slo as tslo  # noqa: E402
from mxnet_tpu_torch.observability import steptimer as tst  # noqa: E402
from mxnet_tpu_torch.observability import timeseries as tts  # noqa: E402
from mxnet_tpu_torch.observability import tracing as ttr  # noqa: E402
from mxnet_tpu_torch.serving import telemetry  # noqa: E402

torch.set_num_threads(2)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("reference_test_slo_capacity_under_torch",
            os.path.join(REPO, "tests", "test_slo_capacity.py"))
OBS = _load("port_training_obs_for_steptimer",
            os.path.join(REPO, "tests", "test_torch_training_obs.py"))

# tests/test_slo_capacity.py:116-293, :308-329 and :415-437
PURE = ["test_ring_bounded_and_eviction_counted",
        "test_ring_rate_window_and_reset",
        "test_ring_windowed_percentile_sees_only_window",
        "test_counts_helpers_exact",
        "test_burn_rate_window_math_exact",
        "test_multiwindow_status_requires_both_windows",
        "test_latency_slo_threshold_above_top_edge_counts_overflow_good",
        "test_burn_gauge_clears_when_window_goes_idle",
        "test_latency_slo_good_total_and_threshold_snap",
        "test_capacity_algebra_exact",
        "test_capacity_empty_window_refuses_headline"]


def _port_names(monkeypatch):
    for name, value in (
            ("MetricsRegistry", treg.MetricsRegistry),
            ("TimeSeriesRing", tts.TimeSeriesRing),
            ("diff_cum_counts", tts.diff_cum_counts),
            ("percentile_from_counts", tts.percentile_from_counts),
            ("SLO", tslo.SLO), ("SLOEngine", tslo.SLOEngine),
            ("cap_mod", tcap)):
        monkeypatch.setattr(REF, name, value)


@pytest.mark.parametrize("case", PURE)
def test_reference_case_on_the_port(case, monkeypatch):
    _port_names(monkeypatch)
    getattr(REF, case)()


def _burst(reg_mod, ts_mod, slo_mod, cap_mod):
    """One scripted window through a package's classes: a latency, an
    availability and an idle SLO over a 12-snapshot ring with a shed
    burst at the end, then the capacity record of the window."""
    reg = reg_mod.MetricsRegistry()
    served = reg.counter("mxtpu_serving_requests_completed_total", "",
                         ("server",)).labels(server="u")
    shed = reg.counter("mxtpu_serving_shed_total", "",
                       ("server", "reason")).labels(server="u",
                                                    reason="queue_full")
    reg.counter("mxtpu_serving_deadline_expired_total", "",
                ("server",)).labels(server="u")
    hist = reg.histogram("mxtpu_serving_latency_seconds", "",
                         ("server",)).labels(server="u")
    ring = ts_mod.TimeSeriesRing(reg, capacity=10)
    rs = np.random.RandomState(4)
    for i in range(12):
        served.inc(int(rs.randint(5, 15)))
        if i >= 9:
            shed.inc(int(rs.randint(1, 6)))
        for v in rs.lognormal(-5, 1.2, size=8):
            hist.observe(float(v))
        ring.record(now=100.0 + 0.5 * i)
    slos = [slo_mod.SLO.latency("lat", threshold_ms=7.0, target=0.9,
                                labels={"server": "u"}),
            slo_mod.SLO.serving_availability("avail", "u", target=0.95),
            slo_mod.SLO.serving_availability("idle", "none")]
    eng = slo_mod.SLOEngine(slos, ring, registry=reg,
                            windows=[(3.0, 1.0, 2.0, slo_mod.STATUS_PAGE),
                                     (4.5, 2.0, 1.0, slo_mod.STATUS_WARN)])
    reports = eng.evaluate()
    rec = cap_mod.build_report(ring, reports, [("serving", "u", slos[0])],
                               chips=1)
    window = {
        "rate": ring.rate("mxtpu_serving_requests_completed_total",
                          {"server": "u"}, window_s=2.0),
        "p90": ring.percentile_over("mxtpu_serving_latency_seconds", 90,
                                    {"server": "u"}, window_s=3.0),
        "series": ring.series("mxtpu_serving_shed_total",
                              {"server": "u", "reason": "queue_full"}),
        "len": len(ring),
    }
    published = {(m.name, tuple(sorted(c.labels_dict.items()))): c.value
                 for m in reg.metrics() if m.name.startswith("mxtpu_slo_")
                 for c in m.children()}
    return reports, rec, window, published


def test_same_snapshots_give_the_same_reports():
    jrep, jrec, jwin, jpub = _burst(jreg, jts, jslo, jcap)
    trep, trec, twin, tpub = _burst(treg, tts, tslo, tcap)
    assert trep == jrep
    assert twin == jwin
    assert tpub == jpub
    assert trec.pop("device") == "cpu"
    assert trec == jrec
    assert {r["status_name"] for r in trep.values()} >= {"breach", "ok"}


def _breach(pkg):
    """The reference's ``test_slo_breach_path_from_typed_deadline_sheds``
    through a package's ModelServer; returns what it asserts on."""
    serving, ts_mod, slo_mod, reg_mod = (
        (jserving, jts, jslo, jreg) if pkg == "jax"
        else (tserving, tts, tslo, treg))
    srv = serving.ModelServer(lambda b: b * 2.0, buckets=[1, 2],
                              max_delay_ms=0.5, item_shape=(3,),
                              dtype="float32",
                              name=f"slo_breach_{pkg}").start()
    srv.warmup()
    for f in [srv.submit(np.zeros(3, np.float32)) for _ in range(2)]:
        f.result(timeout=60)
    for _ in range(8):
        with pytest.raises(serving.DeadlineExceededError):
            srv.submit(np.zeros(3, np.float32), deadline_ms=0,
                       tenant="bad_tenant")
    srv.shutdown()
    label = srv._stats.server_label
    reg = reg_mod.get_registry()
    ring = ts_mod.TimeSeriesRing(reg, capacity=8)
    ring.record(now=0.0)
    slo = slo_mod.SLO.serving_availability(f"breach_{pkg}", label,
                                           target=0.99)
    rep = slo_mod.SLOEngine([slo], ring, registry=reg,
                            windows=[]).evaluate()[f"breach_{pkg}"]
    tenant = reg.get("mxtpu_serving_tenant_requests_total").labels(
        server=label, tenant="bad_tenant", outcome="expired").value
    status = reg.get("mxtpu_slo_status").labels(slo=f"breach_{pkg}").value
    rep.pop("name")
    rep.pop("description")          # names the server
    return rep, tenant, status


def _tenants(pkg):
    serving, reg_mod = (jserving, jreg) if pkg == "jax" \
        else (tserving, treg)
    srv = serving.ModelServer(lambda b: b + 1.0, buckets=[1, 2, 4],
                              max_delay_ms=0.5, item_shape=(2,),
                              dtype="float32",
                              name=f"tenant_{pkg}").start()
    srv.warmup()
    for f in [srv.submit(np.zeros(2, np.float32), tenant=f"t{i % 2}")
              for i in range(6)]:
        f.result(timeout=60)
    snap = srv._stats.snapshot()
    srv.shutdown()
    label = srv._stats.server_label
    counter = reg_mod.get_registry().get(
        "mxtpu_serving_tenant_requests_total")
    tenants = sorted(c.labels_dict["tenant"] for c in counter.children()
                     if c.labels_dict.get("server") == label)
    return snap["tenants"], tenants


@pytest.mark.parametrize("case", [_breach, _tenants],
                         ids=["breach_from_deadline_sheds",
                              "tenant_attribution"])
def test_served_path_matches_the_reference(case):
    assert case("torch") == case("jax")


def test_breach_is_reported_on_the_port():
    rep, tenant, status = _breach("torch")
    assert rep["good"] == 2 and rep["total"] == 10
    assert rep["status_name"] == "breach" and status == tslo.STATUS_BREACH
    assert tenant == 8


def _timed_loop(reg_mod, tr_mod, st_mod, loop, monkeypatch):
    reg = reg_mod.MetricsRegistry()
    monkeypatch.setattr(reg_mod, "_global", reg)
    monkeypatch.setattr(tr_mod, "_global", tr_mod.Tracer(registry=reg))
    timer = st_mod.StepTimer()
    loop(False, timer)
    out = {}
    for m in reg.metrics():
        if m.name.startswith("mxtpu_training_"):
            c = m.children()[0]
            out[m.name] = c.count if hasattr(c, "count") else (
                c.value if m.name.endswith("_total") else None)
    return out, timer.steps


def test_step_timer_series_and_counts_match_the_reference(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_METRICS_GRAD_NORM", raising=False)

    def timed(loop_mod_fn):
        def loop(compiled, timer):
            orig = OBS._batches

            def batches():
                for b in orig():
                    with timer.step(batch_size=8):
                        yield b
            monkeypatch.setattr(OBS, "_batches", batches)
            try:
                loop_mod_fn(compiled)
            finally:
                monkeypatch.setattr(OBS, "_batches", orig)
        return loop

    j, jsteps = _timed_loop(jreg, jtr, jst, timed(OBS._j_loop), monkeypatch)
    t, tsteps = _timed_loop(treg, ttr, tst, timed(OBS._t_loop), monkeypatch)
    assert t == j and tsteps == jsteps == 2
    assert t["mxtpu_training_steps_total"] == 2
    assert t["mxtpu_training_step_seconds"] == 2
    assert t["mxtpu_training_data_wait_seconds"] == 2
    assert t["mxtpu_training_compute_seconds"] == 2
    assert t["mxtpu_training_examples_total"] == 16


def test_estimator_default_step_timer_handler(monkeypatch):
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.contrib.estimator import Estimator
    from mxnet_tpu_torch.gluon.contrib.estimator.event_handler import \
        StepTimerHandler
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    reg = treg.MetricsRegistry()
    monkeypatch.setattr(treg, "_global", reg)
    net = nn.Dense(3, prefix="steptimer_")
    net.initialize(device="cpu")
    est = Estimator(net, SoftmaxCrossEntropyLoss())
    handlers = est._prepare_handlers(None, 1, None, None)
    assert any(isinstance(h, StepTimerHandler) for h in handlers)
    rs = np.random.RandomState(0)
    data = [(torch.from_numpy(rs.randn(4, 6).astype(np.float32)),
             torch.from_numpy(rs.randint(0, 3, (4,)).astype(np.float32)))
            for _ in range(2)]
    est.fit(data, epochs=1)
    assert reg.counter("mxtpu_training_steps_total").value == 2
    assert reg.counter("mxtpu_training_optimizer_steps_total").value == 2
    assert reg.gauge("mxtpu_training_examples_per_sec").value > 0
    assert 0.0 <= reg.gauge("mxtpu_training_data_fraction").value <= 1.0


class _FakeLib:
    def __getattr__(self, name):
        return type("Fn", (), {})()


class _FakeGraph:
    def register_generator_state(self, gen):
        pass


def test_compile_bridge_counts_loads_and_captures(monkeypatch):
    import contextlib
    reg = treg.MetricsRegistry()
    monkeypatch.setattr(treg, "_global", reg)
    monkeypatch.setattr(kernels, "_builds", list(kernels._builds))
    monkeypatch.setattr(kernels, "_captures", list(kernels._captures))
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: _FakeLib())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    assert compilemon.install_jax_monitoring_bridge() is reg
    assert reg.get("mxtpu_xla_events_total") is not None
    b0 = kernels.build_count() + kernels.capture_count()
    c0 = compilemon.compile_count()
    try:
        kernels._load("fake-lib", "fake.so", {"mxt_fake": []}, False)
        kernels.capture(lambda: None, object(), warmed=True,
                        what="a stub")
    finally:
        kernels._libs.pop("fake-lib", None)
    assert kernels.build_count() + kernels.capture_count() - b0 == 2
    assert compilemon.compile_count() - c0 == 2
    assert telemetry.compile_count() == compilemon.compile_count()
    assert reg.counter("mxtpu_xla_cache_hits_total").value == 1
    assert reg.histogram("mxtpu_xla_compile_seconds").count == 2
    assert list(reg.get("mxtpu_xla_events_total").children()) == []
    with telemetry.CompileCounter() as cc:
        compilemon.note_compile(0.5)
    assert cc.count == 1

"""PyTorch port, the serving chaos matrix: the ``ModelServer`` half of
``tests/test_serving_chaos.py`` (``:101-376``) against
``mxnet_tpu_torch.serving.ModelServer`` on the CPU, armed through the
port's own switchboard (``mxnet_tpu_torch.resilience.faults``: the
server's ``serving.dispatch`` and ``serving.worker`` sites).

Every row is pure behaviour (an echo model in numpy), so each runs on
both packages, the JAX package's server armed through its own
switchboard, the port's through the port's: each side passes the
reference test's assertions, and the two report the same outcome
partition (results and typed errors per request) and the same counters
(``stats()``'s submitted / completed / failed / shed / deadline /
poison / breaker numbers).

The invariant under every fault: every submitted Future resolves, with
a result or a typed error.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

from mxnet_tpu import serving as jserving  # noqa: E402
from mxnet_tpu.resilience import faults as jfaults  # noqa: E402
from mxnet_tpu_torch import serving as tserving  # noqa: E402
from mxnet_tpu_torch.resilience import faults as tfaults  # noqa: E402

torch.set_num_threads(2)

ITEM = (2,)
PACKAGES = {"jax": (jserving, jfaults), "torch": (tserving, tfaults)}
COUNTERS = ("requests_submitted", "requests_completed", "requests_failed",
            "shed", "deadline_expired", "poison_isolated", "breaker_state")


@pytest.fixture(autouse=True)
def _reset_faults():
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


class Pkg:
    """One package's serving module, fault switchboard and a name tag."""

    def __init__(self, tag):
        self.tag = tag
        self.serving, self.faults = PACKAGES[tag]

    def server(self, name, fn=None, **kw):
        kw.setdefault("buckets", [1, 2, 4])
        kw.setdefault("max_delay_ms", 20.0)
        return self.serving.ModelServer(
            fn or (lambda b: b * 2.0), item_shape=ITEM, dtype="float32",
            name=f"{self.tag}_{name}", **kw).start()


def _resolve_all(futs, timeout=30):
    results, errors = [], []
    for f in futs:
        try:
            results.append(f.result(timeout=timeout))
        except BaseException as exc:
            errors.append(exc)
    return results, errors


def _partition(futs):
    """Per request: ("ok", result bytes) or the error's type name."""
    out = []
    for f in futs:
        try:
            out.append(("ok", np.asarray(f.result(timeout=30)).tobytes()))
        except BaseException as exc:
            out.append(type(exc).__name__)
    return out


def _counters(srv):
    st = srv.stats()
    return {k: st[k] for k in COUNTERS}


def _zeros():
    return np.zeros(ITEM, np.float32)


# ------------------------------------------------------------ rows --
def row_transient(p):
    srv = p.server("transient")
    p.faults.script("serving.dispatch", [RuntimeError("transient blip")])
    futs = [srv.submit(np.full(ITEM, i, np.float32)) for i in range(4)]
    results, errors = _resolve_all(futs)
    srv.shutdown()
    assert not errors
    for i, r in enumerate(results):
        np.testing.assert_array_equal(r, np.full(ITEM, 2.0 * i))
    st = srv.stats()
    assert st["requests_failed"] == 0 and st["requests_completed"] == 4
    assert st["breaker_state"] == 0
    return _partition(futs), _counters(srv)


def row_poison(p):
    def fn(batch):
        if (batch == 99.0).any():
            raise ValueError("poison row")
        return batch * 2.0

    srv = p.server("poison", fn=fn, buckets=[1, 2, 4, 8],
                   max_delay_ms=50.0)
    vals = [1, 2, 99, 4, 5, 6, 7, 8]
    futs = [srv.submit(np.full(ITEM, v, np.float32)) for v in vals]
    results, errors = _resolve_all(futs)
    srv.shutdown()
    assert len(results) == 7 and len(errors) == 1
    assert isinstance(errors[0], ValueError)
    assert "poison row" in str(errors[0])
    st = srv.stats()
    assert st["poison_isolated"] == 1
    assert st["requests_completed"] == 7 and st["requests_failed"] == 1
    return _partition(futs), _counters(srv)


def row_slow_compute(p):
    gate = p.faults.block_at("serving.dispatch")
    srv = p.server("slow", buckets=[1], max_delay_ms=0.1)
    f_slow = srv.submit(_zeros())
    assert gate.wait_reached(10)
    f_dead = srv.submit(_zeros(), deadline_ms=5)
    f_live = srv.submit(_zeros())
    time.sleep(0.03)
    gate.release()
    np.testing.assert_array_equal(f_slow.result(timeout=30), 0.0)
    np.testing.assert_array_equal(f_live.result(timeout=30), 0.0)
    with pytest.raises(p.serving.DeadlineExceededError):
        f_dead.result(timeout=30)
    srv.shutdown()
    st = srv.stats()
    assert st["deadline_expired"] == 1 and st["requests_failed"] == 1
    return _partition([f_slow, f_dead, f_live]), _counters(srv)


def row_deadline_at_submit(p):
    srv = p.server("dl0")
    with pytest.raises(p.serving.DeadlineExceededError):
        srv.submit(_zeros(), deadline_ms=0)
    srv.shutdown()
    assert srv.stats()["deadline_expired"] == 1
    return [], _counters(srv)


def row_estimated_wait(p):
    p.faults.delay_at("serving.dispatch", 0.06)
    srv = p.server("est", buckets=[1], max_delay_ms=0.1)
    for _ in range(3):
        srv.predict(_zeros(), timeout=30)
    gate = p.faults.block_at("serving.dispatch")
    f_busy = srv.submit(_zeros())
    assert gate.wait_reached(10)
    f_q = srv.submit(_zeros())
    with pytest.raises(p.serving.Overloaded) as ei:
        srv.submit(_zeros(), deadline_ms=1.0)
    assert ei.value.reason == "deadline_unmeetable"
    gate.release()
    _resolve_all([f_busy, f_q])
    srv.shutdown()
    assert srv.stats()["shed"].get("deadline_unmeetable") == 1
    return _partition([f_busy, f_q]), _counters(srv)


def row_queue_overflow(p):
    gate = p.faults.block_at("serving.dispatch")
    srv = p.server("full", buckets=[1], max_delay_ms=0.1, max_queue=2)
    f_busy = srv.submit(_zeros())
    assert gate.wait_reached(10)
    admitted = [srv.submit(_zeros()) for _ in range(2)]
    for _ in range(3):
        with pytest.raises(p.serving.Overloaded) as ei:
            srv.submit(_zeros())
        assert ei.value.reason == "queue_full"
    gate.release()
    results, errors = _resolve_all([f_busy] + admitted)
    srv.shutdown()
    assert len(results) == 3 and not errors
    st = srv.stats()
    assert st["shed"]["queue_full"] == 3
    assert st["requests_submitted"] == 3
    return _partition([f_busy] + admitted), _counters(srv)


def row_worker_death(p):
    p.faults.crash_at_point("serving.worker", nth=1)
    srv = p.server("death", buckets=[1, 2, 4], max_delay_ms=100.0)
    futs = [srv.submit(_zeros()) for _ in range(5)]
    results, errors = _resolve_all(futs, timeout=30)
    assert len(results) + len(errors) == 5
    assert all(isinstance(e, p.serving.ServerClosed) for e in errors)
    assert errors
    p.faults.reset()
    with pytest.raises(p.serving.ServerClosed):
        srv.submit(_zeros())
    srv.shutdown()
    return _partition(futs), _counters(srv)


def row_breaker(p):
    state = {"broken": True}

    def fn(batch):
        if state["broken"]:
            raise RuntimeError("backend down")
        return batch + 1.0

    srv = p.server("breaker", fn=fn, buckets=[1], max_delay_ms=0.1,
                   breaker_threshold=2, breaker_cooldown_ms=50)
    futs = []
    for _ in range(2):
        f = srv.submit(_zeros())
        futs.append(f)
        with pytest.raises(RuntimeError):
            f.result(timeout=30)
    deadline = time.monotonic() + 10
    while (srv.stats()["breaker_state"] != 1
           and time.monotonic() < deadline):
        time.sleep(0.005)
    assert srv.stats()["breaker_state"] == 1
    with pytest.raises(p.serving.CircuitOpenError) as ei:
        srv.submit(_zeros())
    assert ei.value.reason == "breaker_open"
    assert srv.stats()["shed"]["breaker_open"] == 1
    opened = _counters(srv)
    state["broken"] = False
    time.sleep(0.12)
    np.testing.assert_array_equal(srv.predict(_zeros(), timeout=30), 1.0)
    srv.shutdown()
    assert srv.stats()["breaker_state"] == 0
    return _partition(futs), (opened, _counters(srv))


def row_recurring_poison(p):
    def fn(batch):
        if (batch == 99.0).any():
            raise ValueError("poison row")
        return batch

    srv = p.server("poisbrk", fn=fn, buckets=[1, 2], max_delay_ms=30.0,
                   breaker_threshold=2)
    futs = []
    for _ in range(4):
        f_bad = srv.submit(np.full(ITEM, 99.0, np.float32))
        f_ok = srv.submit(np.full(ITEM, 1.0, np.float32))
        futs += [f_bad, f_ok]
        with pytest.raises(ValueError):
            f_bad.result(timeout=30)
        np.testing.assert_array_equal(f_ok.result(timeout=30), 1.0)
    assert srv.stats()["breaker_state"] == 0
    srv.shutdown()
    assert srv.stats()["poison_isolated"] == 4
    assert srv.stats()["requests_completed"] == 4
    return _partition(futs), _counters(srv)


def row_drain_under_load(p):
    gate = p.faults.block_at("serving.dispatch")
    srv = p.server("drain", buckets=[1], max_delay_ms=0.1, max_queue=3)
    f_busy = srv.submit(_zeros())
    assert gate.wait_reached(10)
    f_ok = srv.submit(_zeros())
    f_dead = srv.submit(_zeros(), deadline_ms=5)
    f_q = srv.submit(_zeros())
    with pytest.raises(p.serving.Overloaded):
        srv.submit(_zeros())
    time.sleep(0.03)
    done = threading.Event()

    def _shutdown():
        srv.shutdown(drain=True)
        done.set()

    t = threading.Thread(target=_shutdown, daemon=True)
    t.start()
    gate.release()
    assert done.wait(30)
    futs = [f_busy, f_ok, f_dead, f_q]
    served, errors = _resolve_all(futs)
    assert len(served) == 3 and len(errors) == 1
    assert isinstance(errors[0], p.serving.DeadlineExceededError)
    st = srv.stats()
    assert st["requests_submitted"] == 4
    assert st["requests_completed"] == 3 and st["requests_failed"] == 1
    assert st["deadline_expired"] == 1
    assert st["shed"] == {"queue_full": 1}
    return _partition(futs), _counters(srv)


ROWS = {f.__name__[4:]: f for f in (
    row_transient, row_poison, row_slow_compute, row_deadline_at_submit,
    row_estimated_wait, row_queue_overflow, row_worker_death, row_breaker,
    row_recurring_poison, row_drain_under_load)}


@pytest.mark.parametrize("row", sorted(ROWS))
def test_chaos_row_same_outcome_on_both_packages(row):
    """The row's reference assertions hold on each package, and both
    report the same per-request outcomes and counters."""
    got = {tag: ROWS[row](Pkg(tag)) for tag in ("jax", "torch")}
    assert got["torch"] == got["jax"]


# ---------------------------------------------------- error hierarchy --
def test_typed_error_hierarchy_unified():
    from mxnet_tpu_torch.serving import (
        CircuitOpenError, DeadlineExceededError, Overloaded,
        SequenceEvictedError, ServerClosed, ServingError)
    for exc_type in (ServerClosed, Overloaded, CircuitOpenError,
                     DeadlineExceededError, SequenceEvictedError):
        assert issubclass(exc_type, ServingError)
        assert issubclass(exc_type, RuntimeError)
    assert issubclass(CircuitOpenError, Overloaded)
    from mxnet_tpu_torch.serving import llm as llm_mod
    assert llm_mod.SequenceEvictedError is SequenceEvictedError
    assert llm_mod.DeadlineExceededError is DeadlineExceededError
    q = tserving.MicroBatchQueue()
    q.close()
    with pytest.raises(ServingError):
        q.submit(1)
    err = DeadlineExceededError("x", tokens=[1, 2], seq_id=7)
    assert err.tokens == [1, 2] and err.seq_id == 7


def test_worker_death_writes_a_flight_bundle(tmp_path):
    """The dying worker's crash dump names the server (the port's flight
    recorder) before every Future resolves typed."""
    from mxnet_tpu_torch.observability import get_flightrecorder
    fr = get_flightrecorder()
    fr.enable(out_dir=str(tmp_path))
    try:
        tfaults.crash_at_point("serving.worker", nth=1)
        srv = Pkg("torch").server("flight", max_delay_ms=50.0)
        futs = [srv.submit(_zeros()) for _ in range(3)]
        _, errors = _resolve_all(futs)
        assert len(errors) == 3
        srv.shutdown()
    finally:
        fr.disable()
    assert any(os.scandir(str(tmp_path)))

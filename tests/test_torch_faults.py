"""PyTorch port, the resilience primitives
(``mxnet_tpu_torch/resilience/{faults,atomic,preemption}.py``) against the
JAX package's (``mxnet_tpu/resilience/``), driven with the same calls.

- the fault switchboard: one schedule of ``script`` / ``block_at`` /
  ``delay_at`` / ``crash_at_point`` / ``kill_write_at`` arms a fresh
  injector of each package, the same sequence of ``check`` / ``point`` /
  file writes runs against both, and the two traces of raises, crashes,
  sleeps, parks and passes are equal;
- ``atomic_write``: the same bytes and crc32 published, and a write
  killed at byte N leaves the temp file and no target on both;
- ``PreemptionGuard`` on ``SIGUSR1``: the flag, the signal number, the
  callbacks and the restored handler.

Pure Python on both sides: exact equality, no tolerance.
"""
import io
import os
import signal
import sys
import threading
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

from mxnet_tpu.resilience import atomic as jatomic  # noqa: E402
from mxnet_tpu.resilience import faults as jfaults  # noqa: E402
from mxnet_tpu.resilience import preemption as jpre  # noqa: E402
from mxnet_tpu_torch.resilience import atomic as tatomic  # noqa: E402
from mxnet_tpu_torch.resilience import faults as tfaults  # noqa: E402
from mxnet_tpu_torch.resilience import preemption as tpre  # noqa: E402
from mxnet_tpu_torch import resilience as tres  # noqa: E402

torch.set_num_threads(2)

PAIRS = [(jfaults, jatomic, jpre), (tfaults, tatomic, tpre)]

# (arming calls, then the driven calls): ("check"|"point", site) or
# ("write", path, [chunk sizes])
SCHEDULES = {
    "script": (
        [("script", "llm.decode", [RuntimeError("a"), None,
                                   ValueError("b")]),
         ("script", "llm.prefill", [KeyError("p")])],
        [("check", "llm.decode")] * 5 + [("check", "llm.prefill")] * 2
        + [("point", "llm.decode")]),
    "crash_at_point": (
        [("crash_at_point", "llm.worker", 3),
         ("crash_at_point", "flight", 1)],
        [("point", "llm.worker")] * 4 + [("check", "llm.worker")]
        + [("point", "flight.dump"), ("point", "flight.dump")]),
    "delay_at": (
        [("delay_at", "llm.decode", 0.004, 2),
         ("delay_at", "llm", 0.001, None)],
        [("check", "llm.decode")] * 3 + [("point", "llm.worker"),
                                         ("check", "other")]),
    "kill_write_at": (
        [("kill_write_at", "ckpt", 10)],
        [("write", "run/ckpt.bin", [4, 4, 4]),
         ("write", "run/other.bin", [8, 8]),
         ("write", "ckpt-2", [12])]),
    "mixed": (
        [("script", "llm.draft", [None, OSError("io")]),
         ("crash_at_point", "llm.draft", 3),
         ("delay_at", "llm.draft", 0.002, 1)],
        [("check", "llm.draft")] * 4),
}


def _drive(faults, schedule, monkeypatch):
    """The trace of ``schedule`` on a fresh injector of ``faults``."""
    inj = faults.FaultInjector()
    arming, calls = schedule
    for name, *args in arming:
        getattr(inj, name)(*args)
    trace = []
    monkeypatch.setattr(time, "sleep", lambda s: trace.append(("sleep",
                                                              round(s, 6))))
    for kind, site, *rest in calls:
        try:
            if kind == "write":
                buf = io.BytesIO()
                f = inj.wrap_file(buf, site)
                for n in rest[0]:
                    f.write(b"x" * n)
                trace.append(("wrote", site, len(buf.getvalue())))
                continue
            getattr(inj, kind)(site)
            trace.append(("pass", kind, site))
        except faults.InjectedCrash as exc:
            trace.append(("crash", kind, site, str(exc)))
        except Exception as exc:
            trace.append(("raise", kind, site, type(exc).__name__,
                          str(exc)))
    monkeypatch.undo()
    return trace


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_same_schedule_same_trace(name, monkeypatch):
    want = _drive(jfaults, SCHEDULES[name], monkeypatch)
    got = _drive(tfaults, SCHEDULES[name], monkeypatch)
    assert got == want
    assert any(t[0] != "pass" for t in got)        # the schedule fired


@pytest.mark.parametrize("pkg", range(2), ids=["jax", "torch"])
def test_block_at_parks_until_released(pkg):
    """A ``block_at`` gate parks the matching call on another thread
    until the test releases it; ``reset`` releases every gate; an
    unarmed injector passes at once."""
    faults = PAIRS[pkg][0]
    inj = faults.FaultInjector()
    gate = inj.block_at("llm.decode")
    done = threading.Event()
    t = threading.Thread(target=lambda: (inj.check("llm.decode"),
                                         done.set()), daemon=True)
    t.start()
    assert gate.wait_reached(10)
    assert not done.wait(0.05)                     # parked
    gate.release()
    assert done.wait(10)
    t.join(10)
    assert not t.is_alive()
    gate2 = inj.block_at("llm.worker")
    t2 = threading.Thread(target=inj.point, args=("llm.worker",),
                          daemon=True)
    t2.start()
    assert gate2.wait_reached(10)
    inj.reset()                                    # releases the gate
    t2.join(10)
    assert not t2.is_alive() and not inj.armed
    inj.check("llm.worker")                        # unarmed: no-op


def test_module_level_switchboard_is_the_ports_own():
    """The port's module functions drive its own global injector, not
    the JAX package's, and ``InjectedCrash`` is a BaseException."""
    tfaults.reset()
    jfaults.reset()
    try:
        tfaults.script("llm.decode", [RuntimeError("port")])
        jfaults.check("llm.decode")                # the other one: no-op
        with pytest.raises(RuntimeError, match="port"):
            tfaults.check("llm.decode")
    finally:
        tfaults.reset()
    assert issubclass(tres.InjectedCrash, BaseException)
    assert not issubclass(tres.InjectedCrash, Exception)
    assert tres.InjectedCrash is tfaults.InjectedCrash


@pytest.mark.parametrize("torn", [False, True], ids=["clean", "torn"])
def test_atomic_write_publishes_or_leaves_the_temp(tmp_path, torn):
    payload = bytes(range(256)) * 9
    seen = []
    for faults, atomic, _ in PAIRS:
        d = tmp_path / faults.__name__.split(".")[0]
        d.mkdir()
        target = d / "bundle.json"
        faults.reset()
        if torn:
            faults.kill_write_at("bundle.json", 1000)
        try:
            with atomic.atomic_write(target) as sink:
                sink.write(payload[:1500])
                sink.write(payload[1500:])
        except faults.InjectedCrash:
            assert torn
        finally:
            faults.reset()
        left = sorted(os.listdir(d))
        if torn:
            assert not target.exists()
            assert len(left) == 1 and atomic.is_temp_path(left[0])
            assert os.path.getsize(d / left[0]) == 1000
            seen.append(left[0].rsplit("-", 1)[0])
        else:
            assert left == ["bundle.json"]
            assert target.read_bytes() == payload
            seen.append((sink.crc32, sink.nbytes))
    assert seen[0] == seen[1]
    assert tatomic.is_temp_path("x/.tmp-a") and not tatomic.is_temp_path(
        "x/a.tmp-")


@pytest.mark.parametrize("pkg", range(2), ids=["jax", "torch"])
def test_preemption_guard_on_sigusr1(pkg):
    pre = PAIRS[pkg][2]
    before = signal.getsignal(signal.SIGUSR1)
    hits = []
    guard = pre.PreemptionGuard(signals=(signal.SIGUSR1,),
                                callback=hits.append)
    guard.add_callback(lambda s: hits.append(-s))
    with guard:
        assert not guard.requested and not guard.wait(0.01)
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.wait(10)
        assert guard.requested and guard.signum == signal.SIGUSR1
        assert hits == [signal.SIGUSR1, -signal.SIGUSR1]
        guard.clear()
        assert not guard.requested and guard.signum is None
    assert signal.getsignal(signal.SIGUSR1) == before
    assert tres.PreemptionGuard is tpre.PreemptionGuard

"""Deterministic fault-injection harness (the port of
``mxnet_tpu/resilience/faults.py``; standard library only).

The recovery paths in this subsystem (atomic writes, retry/backoff,
preemption checkpoints) are only trustworthy if tests can *make* the
faults happen. This module is the single switchboard: production code
calls the hooks below (``check``, ``wrap_file``, ``on_step``) which are
near-free no-ops until a test arms an injector, then:

- ``kill_write_at(match, nbytes)`` aborts a file write after exactly N
  bytes, leaving the partial temp file on disk — a simulated SIGKILL
  mid-checkpoint (the atomic layer deliberately does NOT clean up on
  :class:`InjectedCrash`, because a real dead process wouldn't).
- ``script(site, [OSError(...), OSError(...), None])`` raises a scripted
  exception sequence at a named call site — simulated transient I/O or
  coordinator-connect failures, consumed one per call.
- ``sigterm_at_step(k)`` delivers a real ``SIGTERM`` to this process the
  k-th time a training step completes — the preemption drill.
- ``crash_at_point(match, nth)`` crashes (InjectedCrash) at the nth
  named crash *point* whose name contains ``match`` — points mark
  phase boundaries a byte count cannot reach (the rename publishing a
  manifest, the k-th shard write of a sharded checkpoint, the prune
  pass after a commit).
- ``block_at(site)`` returns a :class:`Gate` that makes the next
  matching ``check``/``point`` call park until the test releases it —
  the deterministic way to hold a background checkpoint writer mid-save
  while asserting the training thread keeps stepping (no sleeps).
- ``delay_at(site, seconds, times=N)`` sleeps at a matching
  ``check``/``point`` call — injected slow compute for the serving
  chaos harness (a dispatch that suddenly takes 50ms makes queued
  deadlines expire without faking any clock).

The decode serving hot paths are instrumented with these hooks
(``llm.prefill`` / ``llm.draft`` / ``llm.decode`` in the engine,
``llm.worker`` in the server's loop), each on the host before the step's
graph replays, never inside a captured body (a check there would run
once, at capture). All schedules are explicit and deterministic: no
randomness, no timers.
"""
from __future__ import annotations

import os
import signal
import threading
import time

__all__ = ["InjectedCrash", "FaultInjector", "Gate", "active", "reset",
           "kill_write_at", "script", "sigterm_at_step", "crash_at_point",
           "block_at", "delay_at", "check", "wrap_file", "on_step",
           "point"]


class InjectedCrash(BaseException):
    """Simulated hard process death mid-write.

    BaseException on purpose: library code that catches ``Exception``
    (best-effort checkpoint handlers, cleanup paths) must not swallow a
    simulated crash, exactly as it could not swallow a real SIGKILL.
    """


class _CountingFile:
    """File proxy that counts written bytes and crashes at a threshold."""

    def __init__(self, f, limit, injector):
        self._f = f
        self._limit = limit
        self._written = 0
        self._injector = injector

    def write(self, data):
        room = self._limit - self._written
        if room <= 0:
            raise InjectedCrash(
                f"injected write kill at byte {self._limit}")
        if len(data) > room:
            self._f.write(data[:room])
            self._f.flush()
            self._written = self._limit
            raise InjectedCrash(
                f"injected write kill at byte {self._limit}")
        self._f.write(data)
        self._written += len(data)

    def __getattr__(self, item):
        return getattr(self._f, item)


class Gate:
    """A release-once barrier a fault site parks on (``block_at``).
    ``reached`` is set when the hooked code arrives; the blocked thread
    continues only after ``release()``. Released gates stay open."""

    def __init__(self):
        self.reached = threading.Event()
        self._go = threading.Event()

    def release(self):
        self._go.set()

    def wait_reached(self, timeout=10.0):
        return self.reached.wait(timeout)

    def _pass_through(self):
        self.reached.set()
        self._go.wait()


class FaultInjector:
    """Holds the armed fault schedules. One global instance (``active``)
    is consulted by the resilience hooks; tests arm it and ``reset()``
    in teardown."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with getattr(self, "_lock", threading.Lock()):
            self._write_kills = []        # [(substr, nbytes)]
            self._scripts = {}            # site -> list of Exception|None
            self._points = []             # [[substr, countdown]]
            self._delays = []             # [[substr, seconds, remaining]]
            gates = getattr(self, "_gates", [])
            self._gates = []              # [(substr, Gate)]
            self._sigterm_step = None
            self._step = 0
            self.armed = False
        for _, gate in gates:
            gate.release()   # never leave a thread parked after teardown

    # ------------------------------------------------------------- arm --
    def kill_write_at(self, match: str, nbytes: int):
        """Abort (InjectedCrash) any write to a path containing ``match``
        after exactly ``nbytes`` bytes."""
        with self._lock:
            self._write_kills.append((match, int(nbytes)))
            self.armed = True

    def script(self, site: str, schedule):
        """Raise the scheduled exceptions, in order, on successive calls
        to ``check(site)``; ``None`` entries (and exhaustion) mean
        success."""
        with self._lock:
            self._scripts.setdefault(site, []).extend(schedule)
            self.armed = True

    def sigterm_at_step(self, k: int):
        """Deliver SIGTERM to this process when step count reaches k
        (1-based, counted by ``on_step``)."""
        with self._lock:
            self._sigterm_step = int(k)
            self._step = 0
            self.armed = True

    def crash_at_point(self, match: str, nth: int = 1):
        """Raise InjectedCrash at the ``nth`` call to ``point(name)``
        whose name contains ``match`` (1-based, counted per arming)."""
        with self._lock:
            self._points.append([match, int(nth)])
            self.armed = True

    def delay_at(self, match: str, seconds: float, times: int = None):
        """Sleep ``seconds`` at every ``check``/``point`` call whose
        site name contains ``match`` (injected slow compute). ``times``
        bounds how many calls are slowed (None = every one)."""
        with self._lock:
            self._delays.append([match, float(seconds),
                                 None if times is None else int(times)])
            self.armed = True

    def block_at(self, match: str) -> Gate:
        """Park any ``check``/``point`` call whose site name contains
        ``match`` until the returned :class:`Gate` is released."""
        gate = Gate()
        with self._lock:
            self._gates.append((match, gate))
            self.armed = True
        return gate

    # ----------------------------------------------------------- hooks --
    def _gate_and_crash(self, name: str):
        """Shared tail of check/point: park on matching gates, then fire
        a countdown crash if one reaches zero here."""
        with self._lock:
            gates = [g for m, g in self._gates if m in name]
            sleep_s = 0.0
            for rec in self._delays:
                if rec[0] in name and (rec[2] is None or rec[2] > 0):
                    sleep_s += rec[1]
                    if rec[2] is not None:
                        rec[2] -= 1
            fire = False
            for rec in self._points:
                if rec[0] in name:
                    rec[1] -= 1
                    if rec[1] == 0:
                        fire = True
        if sleep_s > 0:
            time.sleep(sleep_s)
        for gate in gates:
            gate._pass_through()
        if fire:
            raise InjectedCrash(f"injected crash at point {name!r}")

    def check(self, site: str):
        """Consume and raise the next scripted fault for ``site``."""
        if not self.armed:
            return
        with self._lock:
            sched = self._scripts.get(site)
            exc = sched.pop(0) if sched else None
        if exc is not None:
            raise exc
        self._gate_and_crash(site)

    def point(self, name: str):
        """Named crash point (phase boundary). Near-free no-op until a
        test arms ``crash_at_point``/``block_at``."""
        if not self.armed:
            return
        self._gate_and_crash(name)

    def wrap_file(self, f, path: str):
        """Return ``f`` or a crash-at-byte-N proxy if armed for ``path``."""
        if not self.armed:
            return f
        with self._lock:
            for match, nbytes in self._write_kills:
                if match in str(path):
                    return _CountingFile(f, nbytes, self)
        return f

    def on_step(self, step=None):
        """Training-loop step hook; fires the scheduled SIGTERM."""
        if not self.armed or self._sigterm_step is None:
            return
        with self._lock:
            self._step += 1
            fire = self._step == self._sigterm_step
        if fire:
            os.kill(os.getpid(), signal.SIGTERM)


active = FaultInjector()

# Module-level conveniences bound to the global injector.
reset = active.reset
kill_write_at = active.kill_write_at
script = active.script
sigterm_at_step = active.sigterm_at_step
crash_at_point = active.crash_at_point
block_at = active.block_at
delay_at = active.delay_at
check = active.check
point = active.point
wrap_file = active.wrap_file
on_step = active.on_step

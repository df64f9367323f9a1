"""Overload-protection primitives of the serving front end.

:class:`CircuitBreaker` is the "degrade to rejection instead of
crash-looping" lever: dispatch failures (model raises, backend down)
are counted per consecutive run; past ``threshold`` the breaker OPENS
and admission fails fast with :class:`~.errors.CircuitOpenError` while
the queued backlog is rejected typed instead of burning dispatches
that will fail anyway. After a cooldown the breaker goes HALF-OPEN:
one probe dispatch is allowed through — success closes the breaker,
failure re-opens it with the NEXT cooldown from
:func:`backoff_schedule` (exponential + deterministic jitter, so a
fleet of breakers over a shared dead backend does not re-probe in
lockstep).

Config resolution (same order as every serving knob): constructor arg
> ``MXNET_TPU_SERVE_BREAKER_{THRESHOLD,COOLDOWN_MS}`` env var >
default. ``on_state`` observes every transition — the server wires it
to its breaker-state counter.
"""
from __future__ import annotations

import os
import random
import threading
import time

from .envutil import env_int as _env_int, env_float as _env_float
from .errors import CircuitOpenError, DeadlineExceededError

__all__ = ["CircuitBreaker", "shed_if_breaker_open", "resolve_deadline",
           "resolve_overload_knobs", "backoff_schedule",
           "BREAKER_CLOSED", "BREAKER_OPEN", "BREAKER_HALF_OPEN"]

BREAKER_CLOSED = 0
BREAKER_OPEN = 1
BREAKER_HALF_OPEN = 2


def backoff_schedule(max_attempts=5, base_delay=0.05, max_delay=2.0,
                     factor=2.0, jitter=0.5, seed=0):
    """Delay before retry k (k=1..max_attempts-1):
    ``min(base*factor^(k-1), max_delay) * (1 + U[0,jitter))`` with U
    drawn from ``random.Random(seed)``. Deterministic by construction."""
    rng = random.Random(seed)
    out = []
    for k in range(max_attempts - 1):
        d = min(base_delay * (factor ** k), max_delay)
        out.append(d * (1.0 + rng.uniform(0.0, jitter)))
    return out


def resolve_overload_knobs(max_queue, deadline_ms):
    """Resolve the admission knobs (constructor arg >
    ``MXNET_TPU_SERVE_{MAX_QUEUE,DEADLINE_MS}`` env > default),
    normalizing the 0-sentinels: returns ``(max_queue or None,
    default_deadline_ms or None)``."""
    if max_queue is None:
        max_queue = _env_int("MXNET_TPU_SERVE_MAX_QUEUE", 0)
    if deadline_ms is None:
        deadline_ms = _env_float("MXNET_TPU_SERVE_DEADLINE_MS", 0.0)
    return (int(max_queue) if max_queue else None,
            float(deadline_ms) if deadline_ms and deadline_ms > 0
            else None)


def shed_if_breaker_open(breaker, stats, events=None):
    """Submit-side breaker gate: while the breaker is open, count the
    shed (and emit the event when the server keeps an event log) and
    fail fast with CircuitOpenError."""
    if breaker.admit():
        return
    retry_s = breaker.retry_after_s()
    stats.record_shed("breaker_open")
    if events is not None:
        events.emit("shed", reason="breaker_open",
                    retry_after_s=round(retry_s, 4))
    raise CircuitOpenError(
        "circuit breaker open (dispatch failing persistently); "
        f"retry in ~{retry_s * 1e3:.0f}ms", retry_after_s=retry_s)


def resolve_deadline(deadline_ms, default_ms, stats, events=None):
    """Resolve a request's end-to-end deadline (explicit arg > server
    default > none) into an ABSOLUTE monotonic deadline, failing fast
    — typed and counted — when the budget is already spent at submit.
    Returns None for unbounded requests."""
    if deadline_ms is None:
        deadline_ms = default_ms
    if deadline_ms is None:
        return None
    budget_s = float(deadline_ms) / 1e3
    if budget_s <= 0:
        stats.record_deadline_expired()
        if events is not None:
            events.emit("deadline_expired", at="submit")
        raise DeadlineExceededError(
            f"deadline budget {deadline_ms}ms already expired at "
            "submit", deadline_ms=deadline_ms)
    return time.monotonic() + budget_s

# cooldowns for successive re-trips: base * 2^k, deterministic jitter.
# 8 entries is plenty — the schedule is clamped at its last entry.
_MAX_TRIPS = 8


class CircuitBreaker:
    """Consecutive-failure circuit breaker; every method thread-safe.

    ``record_failure()`` / ``record_success()`` are called from the
    dispatch path (worker thread); ``admit()`` from submit (caller
    threads); ``allow_dispatch()`` from the worker before running a
    queued batch. OPEN -> HALF_OPEN happens lazily on the first
    ``admit``/``allow_dispatch`` past the cooldown."""

    def __init__(self, threshold=None, cooldown_ms=None, on_state=None):
        if threshold is None:
            threshold = _env_int("MXNET_TPU_SERVE_BREAKER_THRESHOLD", 5)
        if cooldown_ms is None:
            cooldown_ms = _env_float(
                "MXNET_TPU_SERVE_BREAKER_COOLDOWN_MS", 1000.0)
        self.threshold = max(1, int(threshold))
        base_s = max(cooldown_ms, 1.0) / 1e3
        # seed per process: a fleet of breakers tripped by one shared
        # dead backend must NOT re-probe in lockstep (within a process
        # the schedule stays deterministic)
        self._cooldowns = backoff_schedule(
            max_attempts=_MAX_TRIPS + 1, base_delay=base_s,
            max_delay=base_s * 2 ** (_MAX_TRIPS - 1), factor=2.0,
            jitter=0.1, seed=os.getpid())
        self._on_state = on_state
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED    # guarded-by: _lock
        # consecutive failures PER SITE ("dispatch", "prefill",
        # "decode", ...): a success only resets its own site's run, so
        # a hard-down prefill path trips the breaker even while decode
        # launches for already-admitted sequences keep succeeding
        self._failures = {}         # guarded-by: _lock
        self._trips = 0             # guarded-by: _lock — consecutive
        self._reopen_at = 0.0       # guarded-by: _lock   OPENs unclosed
        if on_state is not None:
            on_state(BREAKER_CLOSED)

    # ------------------------------------------------------- reading --
    @property
    def state(self):
        with self._lock:
            return self._state

    def retry_after_s(self):
        """Remaining cooldown before a half-open probe (0 when not
        OPEN)."""
        with self._lock:
            if self._state != BREAKER_OPEN:
                return 0.0
            return max(0.0, self._reopen_at - time.monotonic())

    # -------------------------------------------------- transitions --
    def _set_state(self, state):
        # guarded-by: caller (every transition site holds self._lock)
        if state == self._state:
            return
        self._state = state
        if self._on_state is not None:
            self._on_state(state)

    def _maybe_half_open(self):
        # guarded-by: caller (admit/allow_dispatch hold self._lock)
        if (self._state == BREAKER_OPEN
                and time.monotonic() >= self._reopen_at):
            self._set_state(BREAKER_HALF_OPEN)

    def admit(self):
        """Submit-side gate: False only while OPEN and still cooling
        down (the caller raises CircuitOpenError)."""
        with self._lock:
            self._maybe_half_open()
            return self._state != BREAKER_OPEN

    def allow_dispatch(self):
        """Worker-side gate: may an already-queued batch be dispatched?
        HALF_OPEN allows the probe; its outcome decides what follows."""
        with self._lock:
            self._maybe_half_open()
            return self._state != BREAKER_OPEN

    def record_failure(self, site="dispatch"):
        """One failed dispatch at ``site``. Returns True when this
        failure tripped (or re-tripped) the breaker."""
        with self._lock:
            n = self._failures.get(site, 0) + 1
            self._failures[site] = n
            if self._state == BREAKER_HALF_OPEN:
                tripped = True          # failed probe: straight back open
            elif (self._state == BREAKER_CLOSED
                  and n >= self.threshold):
                tripped = True
            else:
                tripped = False
            if tripped:
                cd = self._cooldowns[min(self._trips,
                                         len(self._cooldowns) - 1)]
                self._trips += 1
                self._reopen_at = time.monotonic() + cd
                self._set_state(BREAKER_OPEN)
            return tripped

    def record_success(self, site="dispatch"):
        """One clean dispatch at ``site``. CLOSED: reset THIS site's
        consecutive-failure run (other sites' runs keep counting — a
        healthy decode path must not amnesty a failing prefill path).
        HALF_OPEN: the probe succeeded — close and reset everything.
        OPEN: no effect — only a post-cooldown probe may close an open
        breaker."""
        with self._lock:
            if self._state == BREAKER_OPEN:
                return
            if self._state == BREAKER_HALF_OPEN:
                self._failures = {}
                self._trips = 0
                self._set_state(BREAKER_CLOSED)
            else:
                self._failures[site] = 0

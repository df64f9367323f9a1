"""Bounded retry with exponential backoff + deterministic jitter (the
port of ``mxnet_tpu/resilience/retry.py``; standard library only).

For transient faults — a coordinator that isn't up yet, an NFS blip mid
checkpoint — the right response is to wait and try again, a bounded
number of times, with exponentially growing sleeps and jitter so a
whole slice of preempted workers doesn't reconnect in lockstep.

Jitter is drawn from a private seeded ``random.Random`` so a given
(seed, attempt) pair always produces the same delay: tests assert the
exact schedule, and multi-host runs can decorrelate by seeding with
their rank.
"""
from __future__ import annotations

import functools
import random
import time

__all__ = ["RetryError", "backoff_schedule", "call_with_retry", "retry"]


class RetryError(Exception):
    """All attempts exhausted; ``__cause__`` is the last failure."""

    def __init__(self, attempts, last):
        super().__init__(
            f"gave up after {attempts} attempts: {last!r}")
        self.attempts = attempts
        self.last = last


def backoff_schedule(max_attempts=5, base_delay=0.05, max_delay=2.0,
                     factor=2.0, jitter=0.5, seed=0):
    """The exact sleep schedule ``call_with_retry`` will use: delay
    before retry k (k=1..max_attempts-1) is
    ``min(base*factor^(k-1), max_delay) * (1 + U[0,jitter))`` with U
    drawn from ``random.Random(seed)``. Deterministic by construction."""
    rng = random.Random(seed)
    out = []
    for k in range(max_attempts - 1):
        d = min(base_delay * (factor ** k), max_delay)
        out.append(d * (1.0 + rng.uniform(0.0, jitter)))
    return out


def _retry_metrics():
    from ..observability import get_registry
    reg = get_registry()
    return (reg.counter("mxtpu_resilience_retry_total",
                        "Individual retries of transient-fault-guarded "
                        "operations, by operation.", ("op",)),
            reg.counter("mxtpu_resilience_retry_exhausted_total",
                        "Operations that failed every retry attempt, "
                        "by operation.", ("op",)))


def call_with_retry(fn, *args, retry_on=(OSError,), max_attempts=5,
                    base_delay=0.05, max_delay=2.0, factor=2.0,
                    jitter=0.5, seed=0, sleep=None, on_retry=None,
                    op=None, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying on ``retry_on`` exceptions
    up to ``max_attempts`` total attempts with the
    :func:`backoff_schedule` delays. ``sleep`` is injectable so tests
    run instantly; ``on_retry(attempt, exc, delay)`` observes each
    failure. Raises :class:`RetryError` (chained to the last failure)
    when exhausted; non-matching exceptions propagate immediately.

    Every retry (and every exhaustion) increments the shared-registry
    counters ``mxtpu_resilience_retry[_exhausted]_total{op=...}``; ``op``
    defaults to the wrapped function's name. The happy path — success on
    attempt 1 — records nothing and pays no registry cost."""
    if sleep is None:
        sleep = time.sleep   # late-bound: tests stub time.sleep
    delays = backoff_schedule(max_attempts, base_delay, max_delay,
                              factor, jitter, seed)
    last = None
    for attempt in range(1, max_attempts + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as exc:   # noqa: PERF203 — the loop IS the point
            last = exc
            if attempt == max_attempts:
                break
            delay = delays[attempt - 1]
            try:
                _retry_metrics()[0].labels(
                    op=op or getattr(fn, "__name__", "?")).inc()
            except Exception:
                pass
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            sleep(delay)
    try:
        _retry_metrics()[1].labels(
            op=op or getattr(fn, "__name__", "?")).inc()
    except Exception:
        pass
    raise RetryError(max_attempts, last) from last


def retry(**cfg):
    """Decorator form: ``@retry(retry_on=(OSError,), max_attempts=3)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return call_with_retry(fn, *args, **cfg, **kwargs)
        return wrapped
    return deco

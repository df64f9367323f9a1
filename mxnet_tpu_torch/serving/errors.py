"""Typed serving errors — one hierarchy, one base class to catch.

Every way a serving request can fail WITHOUT a model result resolves
its Future with a subclass of :class:`ServingError`, so a caller that
wants "anything the serving layer did to my request" catches exactly
one type while still being able to branch on the precise cause:

- :class:`ServerClosed` — admission closed (drain/shutdown), or the
  worker died and the request could no longer be served;
- :class:`Overloaded` — admission-control shed: bounded queue full,
  estimated wait cannot meet the request deadline, or the circuit
  breaker is open (:class:`CircuitOpenError`). Raised AT submit — the
  request never entered the queue, fail-fast by design;
- :class:`DeadlineExceededError` — the request carried a deadline
  (``deadline_ms=`` / ``MXNET_TPU_SERVE_DEADLINE_MS``) and it expired
  before a result existed: while queued (failed before wasting a
  dispatch), at submit time (budget already <= 0), or — on the LLM
  path — mid-generation (carries the tokens generated so far, like an
  eviction);
- :class:`SequenceEvictedError` — a decode sequence was evicted before
  completing (drain deadline, no-drain shutdown, KV pressure during
  shutdown); carries its partial tokens.

A genuine model failure (poison request) resolves the Future with the
ORIGINAL exception the dispatch raised, not a wrapper — the serving
layer isolates which row failed, it does not mask why.

All of these are ``RuntimeError`` subclasses, so pre-hierarchy callers
that caught ``RuntimeError`` keep working unchanged.
"""
from __future__ import annotations

__all__ = ["ServingError", "ServerClosed", "Overloaded",
           "CircuitOpenError", "DeadlineExceededError",
           "SequenceEvictedError"]


class ServingError(RuntimeError):
    """Base class of every typed serving-layer failure."""


class ServerClosed(ServingError):
    """Raised by submit() once admission is closed (drain/shutdown),
    and used to resolve requests a dying/deadline-bounded drain could
    not serve."""


class Overloaded(ServingError):
    """Admission control shed this request instead of queueing it.

    ``reason`` is one of ``"queue_full"`` (bounded queue depth
    reached), ``"deadline_unmeetable"`` (estimated queue wait already
    exceeds the request's deadline budget) or ``"breaker_open"``
    (:class:`CircuitOpenError`). ``depth`` is the queue depth observed
    at the shed decision, when known."""

    def __init__(self, message, reason="queue_full", depth=None):
        super().__init__(message)
        self.reason = reason
        self.depth = depth


class CircuitOpenError(Overloaded):
    """The circuit breaker is open: dispatch has been failing
    persistently and the server is degrading to rejection instead of
    crash-looping. ``retry_after_s`` is the remaining cooldown before
    a half-open probe will be allowed."""

    def __init__(self, message, retry_after_s=None):
        super().__init__(message, reason="breaker_open")
        self.retry_after_s = retry_after_s


class DeadlineExceededError(ServingError):
    """The request's end-to-end deadline expired before it produced a
    result. For LLM generations, ``tokens`` carries everything
    generated before expiry (``reason`` distinguishes a queued expiry
    (``"deadline"``) from a caller-timeout cancellation
    (``"timeout"``))."""

    def __init__(self, message, deadline_ms=None, tokens=(),
                 seq_id=None, reason="deadline"):
        super().__init__(message)
        self.deadline_ms = deadline_ms
        self.tokens = [int(t) for t in tokens]
        self.seq_id = seq_id
        self.reason = reason


class SequenceEvictedError(ServingError):
    """A decode sequence was evicted before completing (drain deadline,
    no-drain shutdown). Carries everything generated so far — the
    caller decides whether a partial generation is usable."""

    def __init__(self, message, tokens=(), seq_id=None,
                 reason="evicted"):
        super().__init__(message)
        self.tokens = [int(t) for t in tokens]
        self.seq_id = seq_id
        self.reason = reason

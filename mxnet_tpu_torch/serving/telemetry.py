"""Serving counters of the port, on plain Python objects.

The JAX package keeps these series on its observability registry; the
port keeps the same numbers in-process, enough for
``LLMServer.stats()``:

- :func:`compile_count` — kernel library builds and loads in this
  process (:func:`mxnet_tpu_torch.kernels.build_count`). PyTorch runs
  eagerly, so nothing else compiles; the serving contract is that it
  does not move after ``warmup()``.
- :class:`Histogram` — a bounded sample window with percentiles.
- :class:`OverloadStats` / :class:`TenantStats` — shed, deadline,
  poison and breaker counters, and per-tenant outcomes.
"""
from __future__ import annotations

import collections
import threading

import numpy as np

from .. import kernels

__all__ = ["compile_count", "Histogram", "OverloadStats", "TenantStats"]


def compile_count():
    """Kernel builds and loads in this process."""
    return kernels.build_count()


class Histogram:
    """The newest ``WINDOW`` observations; percentiles over them (0.0
    when empty)."""

    WINDOW = 8192

    def __init__(self):
        self._samples = collections.deque(maxlen=self.WINDOW)
        self._lock = threading.Lock()

    def observe(self, v):
        with self._lock:
            self._samples.append(float(v))

    def percentile(self, p):
        with self._lock:
            if not self._samples:
                return 0.0
            return float(np.percentile(np.asarray(self._samples), p))


class OverloadStats:
    """Requests shed at admission (by reason), requests failed on an
    expired deadline, poison rows isolated out of batches, and the
    circuit-breaker state (0 closed / 1 open / 2 half-open)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._shed = collections.Counter()      # guarded-by: _lock
        self._deadline = 0                      # guarded-by: _lock
        self._poison = 0                        # guarded-by: _lock
        self._breaker = 0

    def record_shed(self, reason):
        with self._lock:
            self._shed[reason] += 1

    def record_deadline_expired(self, n=1):
        with self._lock:
            self._deadline += n

    def record_poison(self, n=1):
        with self._lock:
            self._poison += n

    def record_breaker_state(self, state):
        self._breaker = int(state)

    def snapshot_into(self, snap):
        """Merge the overload counters into a stats snapshot dict."""
        with self._lock:
            snap["shed"] = {r: n for r, n in self._shed.items() if n}
            snap["deadline_expired"] = self._deadline
            snap["poison_isolated"] = self._poison
        snap["requests_shed"] = sum(snap["shed"].values())
        snap["breaker_state"] = self._breaker
        return snap


class TenantStats:
    """Per-tenant outcomes (submitted / served / shed / expired /
    evicted / failed) and generated tokens; untagged requests (tenant
    None) record nothing."""

    def __init__(self):
        self._lock = threading.Lock()
        self._outcomes = collections.Counter()  # guarded-by: _lock
        self._tokens = collections.Counter()    # guarded-by: _lock

    def record(self, tenant, outcome, n=1):
        if tenant is None:
            return
        with self._lock:
            self._outcomes[(str(tenant), outcome)] += n

    def record_tokens(self, tenant, n):
        if tenant is None:
            return
        with self._lock:
            self._tokens[str(tenant)] += n

    def snapshot(self):
        """{tenant: {outcome: n}} for tagged tenants."""
        out = {}
        with self._lock:
            for (tenant, outcome), n in self._outcomes.items():
                if n:
                    out.setdefault(tenant, {})[outcome] = n
        return out

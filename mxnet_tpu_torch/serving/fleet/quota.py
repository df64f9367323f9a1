"""Per-tenant token-bucket quotas and priority lanes of the port (mirrors
``mxnet_tpu/serving/fleet/quota.py``).

The fleet's tenant-isolation layer sits ABOVE the per-server admission
gates (bounded queue, estimated-wait shed, circuit breaker): a greedy
or poisoned tenant exhausts its OWN bucket and degrades to a typed
``Overloaded(reason="quota")`` while every other tenant's traffic
still reaches the servers untouched. Buckets are created lazily per
tenant; requests without a tenant tag are never quota-gated (same
convention as the per-tenant metric series — untagged traffic creates
no tenant state).

Lanes are a coarse two-class priority scheme: ``interactive`` (the
default, never depth-gated here — the server's own admission bounds
it) and ``batch`` (depth-capped by the router so background traffic
cannot occupy the whole admission queue ahead of interactive work).
"""
from __future__ import annotations

import threading
import time

__all__ = ["LANES", "TokenBucket", "TenantQuota"]

LANES = ("interactive", "batch")


class TokenBucket:
    """Classic monotonic-clock token bucket: refills at ``rate``
    tokens/second up to ``burst``; ``take()`` is all-or-nothing."""

    def __init__(self, rate, burst):
        self.rate = float(rate)
        self.burst = float(burst)
        self._lock = threading.Lock()
        self._tokens = float(burst)     # guarded-by: _lock
        self._t = time.monotonic()      # guarded-by: _lock

    def take(self, n=1.0):
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


class TenantQuota:
    """Lazily-created per-tenant :class:`TokenBucket` map.

    ``rate <= 0`` disables enforcement entirely (every ``allow`` is
    True); ``burst`` defaults to ``2 * rate`` (min 1) so a tenant can
    absorb a short spike of twice its sustained rate."""

    def __init__(self, rate, burst=None):
        self.rate = float(rate or 0.0)
        if burst is None or burst <= 0:
            burst = max(1.0, 2.0 * self.rate)
        self.burst = float(burst)
        self._lock = threading.Lock()
        self._buckets = {}              # guarded-by: _lock

    def allow(self, tenant):
        if self.rate <= 0 or tenant is None:
            return True
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = TokenBucket(self.rate, self.burst)
                self._buckets[tenant] = bucket
        return bucket.take()

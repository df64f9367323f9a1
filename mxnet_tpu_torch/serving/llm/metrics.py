"""LLM serving counters of the port: the fields ``LLMServer.stats()``
returns, on plain counters (the JAX package keeps the same numbers as
``mxtpu_llm_*`` registry series).

Headline numbers: ``tokens_per_sec`` (decode throughput, an EMA over
decode steps) and ``ttft_ms`` (submit -> first generated token, i.e.
queue wait + prefill).
"""
from __future__ import annotations

import threading

from ..telemetry import Histogram, OverloadStats, TenantStats

__all__ = ["LLMStats"]

_COUNTERS = ("submitted", "completed", "failed", "tokens",
             "prefill_tokens", "prefills", "prefill_chunks",
             "prefill_chunk_tokens", "decode_steps", "preemptions",
             "prefix_lookups", "prefix_hits", "prefix_evicts",
             "prefill_saved", "quant_fallbacks")


class LLMStats:
    """Thread-safe LLM serving counters."""

    # smoothing factor of the per-step throughput EMA: heavy enough to
    # damp single-step jitter, light enough to follow a load change
    # within a few steps
    _TPS_ALPHA = 0.2

    def __init__(self, server="llm"):
        self.server_label = str(server)
        self._lock = threading.Lock()
        self._c = dict.fromkeys(_COUNTERS, 0)   # guarded-by: _lock
        self._evicted = {}                      # guarded-by: _lock
        self._gauges = {"queue_depth": 0, "running_seqs": 0,
                        "kv_blocks_in_use": 0, "kv_blocks_total": 0,
                        "kv_blocks_cached": 0, "kv_blocks_shared": 0,
                        "kv_blocks_free": 0, "weight_bytes": 0,
                        "weight_params_per_chip": 0}
        self._weight_dtype = {}
        self._tps = 0.0
        self._ttft = Histogram()
        self._latency = Histogram()
        self._overload = OverloadStats()
        self._tenants = TenantStats()

    def _inc(self, name, n=1):
        with self._lock:
            self._c[name] += n

    # ---------------------------------------------------- recording --
    def record_submit(self):
        self._inc("submitted")

    def record_admission_state(self, waiting, running):
        self._gauges["queue_depth"] = int(waiting)
        self._gauges["running_seqs"] = int(running)

    def record_blocks(self, in_use, total, cached=0, shared=0,
                      free=None):
        g = self._gauges
        g["kv_blocks_in_use"] = int(in_use)
        g["kv_blocks_total"] = int(total)
        g["kv_blocks_cached"] = int(cached)
        g["kv_blocks_shared"] = int(shared)
        g["kv_blocks_free"] = int(total - in_use - cached
                                  if free is None else free)

    def record_prefix_lookup(self, hit_tokens):
        self._inc("prefix_lookups")
        if hit_tokens > 0:
            self._inc("prefix_hits")
            self._inc("prefill_saved", hit_tokens)

    def record_prefix_evict(self, n=1):
        self._inc("prefix_evicts", n)

    def record_prefill(self, prompt_tokens):
        self._inc("prefills")
        self._inc("prefill_tokens", prompt_tokens)

    def record_first_token(self, ttft_s):
        self._ttft.observe(ttft_s)

    def record_decode_step(self, new_tokens, step_s):
        with self._lock:
            self._c["decode_steps"] += 1
            self._c["tokens"] += new_tokens
            inst = new_tokens / max(step_s, 1e-9)
            prev = self._tps
            self._tps = (inst if prev == 0
                         else prev + self._TPS_ALPHA * (inst - prev))

    def record_prefill_token(self):
        """The first generated token comes out of prefill, not a decode
        step — counted so the token counter sees every token."""
        self._inc("tokens")

    def record_prefill_chunk(self, tokens):
        self._inc("prefill_chunks")
        self._inc("prefill_chunk_tokens", tokens)

    def record_preemption(self):
        self._inc("preemptions")

    def record_completed(self, latency_s):
        self._inc("completed")
        self._latency.observe(latency_s)

    def record_evicted(self, reason):
        with self._lock:
            self._evicted[reason] = self._evicted.get(reason, 0) + 1

    def record_failure(self, n=1):
        self._inc("failed", n)

    def record_weight_quant(self, dtype, weight_bytes, params_per_chip):
        self._weight_dtype[str(dtype)] = 1
        self._gauges["weight_bytes"] = int(weight_bytes)
        self._gauges["weight_params_per_chip"] = int(params_per_chip)

    def record_quant_fallback(self, n=1):
        self._inc("quant_fallbacks", n)

    def record_tenant(self, tenant, outcome, n=1):
        self._tenants.record(tenant, outcome, n)

    def record_tenant_tokens(self, tenant, n):
        self._tenants.record_tokens(tenant, n)

    def record_shed(self, reason):
        self._overload.record_shed(reason)

    def record_deadline_expired(self, n=1):
        self._overload.record_deadline_expired(n)

    def record_poison(self, n=1):
        self._overload.record_poison(n)

    def record_breaker_state(self, state):
        self._overload.record_breaker_state(state)

    # -------------------------------------------------------- stats --
    def snapshot(self):
        with self._lock:
            c = dict(self._c)
            evicted = sum(self._evicted.values())
            tps = self._tps
        snap = {
            "requests_submitted": c["submitted"],
            "requests_completed": c["completed"],
            "requests_evicted": evicted,
            "requests_failed": c["failed"],
            "tokens_generated": c["tokens"],
            "prefill_tokens": c["prefill_tokens"],
            "prefills": c["prefills"],
            "prefill_chunks": c["prefill_chunks"],
            "prefill_chunk_tokens": c["prefill_chunk_tokens"],
            "decode_steps": c["decode_steps"],
            "preemptions": c["preemptions"],
            "prefix_lookups": c["prefix_lookups"],
            "prefix_hits": c["prefix_hits"],
            "prefix_evictions": c["prefix_evicts"],
            "prefill_tokens_saved": c["prefill_saved"],
            "quant_fallbacks": c["quant_fallbacks"],
            "tokens_per_sec": tps,
            "ttft_ms": {"p50": self._ttft.percentile(50) * 1e3,
                        "p99": self._ttft.percentile(99) * 1e3},
            "request_ms": {"p50": self._latency.percentile(50) * 1e3,
                           "p99": self._latency.percentile(99) * 1e3},
            "weight_dtype": dict(self._weight_dtype),
            "tenants": self._tenants.snapshot(),
        }
        snap.update(self._gauges)
        return self._overload.snapshot_into(snap)

"""LLM serving telemetry of the port: the reference's ``mxtpu_llm_*``
series (mirrors ``mxnet_tpu/serving/llm/metrics.py``).

Every series lives on the process-wide
:mod:`mxnet_tpu_torch.observability` registry, labeled
``{server="<name>"}`` through the shared claim protocol (a live duplicate
name gets ``#N``), with the overload and tenant series of
:mod:`..telemetry`, so one Prometheus exposition holds the whole
server. ``snapshot()`` is what ``LLMServer.stats()`` returns.

Headline numbers: ``mxtpu_llm_tokens_per_sec`` (decode throughput, an
EMA over decode steps), ``mxtpu_llm_ttft_seconds`` (submit -> first
generated token, i.e. queue wait + prefill; percentiles interpolated
inside its fixed buckets) and the KV-block occupancy gauges. The
``mxtpu_llm_spmd_*`` series exist, as the reference's do on an unsharded
engine, and stay 0 until the tensor-parallel step is ported (ROADMAP.md
§1 item 9).
"""
from __future__ import annotations

import threading

from ...observability import get_registry
from ..telemetry import (OverloadStats, TenantStats,
                         _claim_server_label, _LATENCY_BUCKETS)

__all__ = ["LLMStats"]


class LLMStats:
    """Thread-safe LLM serving counters on the shared registry."""

    def __init__(self, server="llm", registry=None):
        self._reg = registry if registry is not None else get_registry()
        self._server = _claim_server_label(str(server), self)
        r, lbl = self._reg, ("server",)
        s = {"server": self._server}
        self._submitted = r.counter(
            "mxtpu_llm_requests_submitted_total",
            "Decode requests accepted.", lbl).labels(**s)
        self._completed = r.counter(
            "mxtpu_llm_requests_completed_total",
            "Decode requests finished with a full generation.",
            lbl).labels(**s)
        self._evicted = r.counter(
            "mxtpu_llm_requests_evicted_total",
            "Decode requests rejected mid-flight "
            "(drain deadline, shutdown).", ("server", "reason"))
        self._failed = r.counter(
            "mxtpu_llm_requests_failed_total",
            "Decode requests resolved with an error.", lbl).labels(**s)
        self._tokens = r.counter(
            "mxtpu_llm_tokens_generated_total",
            "Tokens produced by decode steps and prefill.",
            lbl).labels(**s)
        self._prefill_tokens = r.counter(
            "mxtpu_llm_prefill_tokens_total",
            "Prompt tokens whose KV was written by prefill "
            "(pad excluded).", lbl).labels(**s)
        self._prefills = r.counter(
            "mxtpu_llm_prefills_total",
            "Prefill launches (admissions incl. preemption resumes).",
            lbl).labels(**s)
        self._decode_steps = r.counter(
            "mxtpu_llm_decode_steps_total",
            "Fixed-shape decode batch launches.", lbl).labels(**s)
        self._preemptions = r.counter(
            "mxtpu_llm_preemptions_total",
            "Sequences evicted for KV pressure and requeued "
            "(restart-based preemption).", lbl).labels(**s)
        self._queue_depth = r.gauge(
            "mxtpu_llm_queue_depth",
            "Sequences waiting for admission.", lbl).labels(**s)
        self._running = r.gauge(
            "mxtpu_llm_running_seqs",
            "Sequences in the decode batch.", lbl).labels(**s)
        self._blocks_in_use = r.gauge(
            "mxtpu_llm_kv_blocks_in_use",
            "Allocated KV cache blocks (refcount >= 1).",
            lbl).labels(**s)
        self._blocks_total = r.gauge(
            "mxtpu_llm_kv_blocks_total",
            "Usable KV cache blocks (pool minus the null block).",
            lbl).labels(**s)
        self._blocks_cached = r.gauge(
            "mxtpu_llm_kv_blocks_cached",
            "Zero-refcount blocks parked in the prefix-cache LRU "
            "(reclaimable capacity holding reusable prefix KV).",
            lbl).labels(**s)
        self._blocks_shared = r.gauge(
            "mxtpu_llm_kv_blocks_shared",
            "Blocks owned by more than one live sequence "
            "(refcount > 1).", lbl).labels(**s)
        self._blocks_free = r.gauge(
            "mxtpu_llm_kv_blocks_free",
            "Strictly free blocks (not allocated, not cached).",
            lbl).labels(**s)
        self._prefix_lookups = r.counter(
            "mxtpu_llm_prefix_lookup_total",
            "Prefix-cache lookups (one per admission while the cache "
            "is enabled).", lbl).labels(**s)
        self._prefix_hits = r.counter(
            "mxtpu_llm_prefix_hit_total",
            "Admissions whose prompt prefix was served from cached "
            "blocks.", lbl).labels(**s)
        self._prefix_evicts = r.counter(
            "mxtpu_llm_prefix_evict_total",
            "Cached prefix blocks reclaimed LRU-oldest-first under KV "
            "pressure.", lbl).labels(**s)
        self._prefill_saved = r.counter(
            "mxtpu_llm_prefill_tokens_saved_total",
            "Prompt tokens whose prefill was skipped because their KV "
            "was served from the prefix cache.", lbl).labels(**s)
        self._tenant_saved = r.counter(
            "mxtpu_llm_tenant_prefill_tokens_saved_total",
            "Prefill tokens saved by prefix-cache hits, attributed "
            "per tenant (tagged requests only).", ("server", "tenant"))
        self._tenant_saved_children = {}
        self._prefill_chunks = r.counter(
            "mxtpu_llm_prefill_chunk_total",
            "Prompt chunks written through the unified step (chunked "
            "prefill).", lbl).labels(**s)
        self._prefill_chunk_tokens = r.counter(
            "mxtpu_llm_prefill_chunk_tokens_total",
            "Prompt tokens written by prefill chunks (pad excluded).",
            lbl).labels(**s)
        self._spec_proposed = r.counter(
            "mxtpu_llm_spec_proposed_total",
            "Draft tokens proposed for speculative verification.",
            lbl).labels(**s)
        self._spec_accepted = r.counter(
            "mxtpu_llm_spec_accept_total",
            "Draft tokens accepted by the target verify step.",
            lbl).labels(**s)
        self._spec_degraded = r.counter(
            "mxtpu_llm_spec_degraded_total",
            "Steps that fell back to plain decode after a draft "
            "dispatch failure.", lbl).labels(**s)
        self._spec_accept_rate = r.gauge(
            "mxtpu_llm_spec_accept_rate",
            "Cumulative draft-token acceptance rate "
            "(accepted / proposed).", lbl).labels(**s)
        self._tps = r.gauge(
            "mxtpu_llm_tokens_per_sec",
            "Decode throughput: smoothed per-step rate (EMA over "
            "decode launches). For precise windows use "
            "rate(mxtpu_llm_tokens_generated_total).",
            lbl).labels(**s)
        self._ttft = r.histogram(
            "mxtpu_llm_ttft_seconds",
            "Time to first token: submit -> first generated token "
            "(queue wait + prefill).", lbl,
            buckets=_LATENCY_BUCKETS).labels(**s)
        self._latency = r.histogram(
            "mxtpu_llm_request_seconds",
            "Per-request end-to-end latency (submit -> last token).",
            lbl, buckets=_LATENCY_BUCKETS).labels(**s)
        self._step_time = r.histogram(
            "mxtpu_llm_decode_step_seconds",
            "Wall time of one decode batch launch.", lbl,
            buckets=_LATENCY_BUCKETS).labels(**s)
        self._adapters_resident = r.gauge(
            "mxtpu_llm_adapters_resident",
            "LoRA adapters currently installed in the device-resident "
            "AdapterBank (in use + cold).", lbl).labels(**s)
        self._adapter_evictions = r.counter(
            "mxtpu_llm_adapter_evictions_total",
            "Adapters retired from the bank, by reason (capacity = "
            "LRU reclaim for a fault-in, republish = replaced by a "
            "newer version, explicit = operator evict).",
            ("server", "reason"))
        self._adapter_evict_children = {}
        self._adapter_requests = r.counter(
            "mxtpu_llm_adapter_requests_total",
            "Generations admitted under each LoRA adapter (base-model "
            "requests create no series).", ("server", "adapter"))
        self._adapter_req_children = {}
        self._adapter_publishes = r.counter(
            "mxtpu_llm_adapter_publish_total",
            "Adapter versions hot-published into the bank (fine-tune "
            "loop or direct publish).", lbl).labels(**s)
        self._tenant_adapter_requests = r.counter(
            "mxtpu_llm_tenant_adapter_requests_total",
            "Adapter-tagged generations attributed per tenant (tagged "
            "requests only).", ("server", "tenant", "adapter"))
        self._tenant_adapter_children = {}
        self._spmd_dispatches = r.counter(
            "mxtpu_llm_spmd_step_dispatch_total",
            "Unified-step launches of the shard_map (SPMD) program — "
            "exactly one device dispatch per engine step when a mesh "
            "is attached (unsharded engines create no series).",
            lbl).labels(**s)
        self._spmd_devices = r.gauge(
            "mxtpu_llm_spmd_mesh_devices",
            "Devices in the engine's decode mesh (0/absent = "
            "unsharded).", lbl).labels(**s)
        self._spmd_axis = r.gauge(
            "mxtpu_llm_spmd_mesh_axis_extent",
            "Extent of each mesh axis the decode step is sharded "
            "over (one series per axis; set at engine construction).",
            ("server", "axis"))
        self._spmd_axis_children = {}
        self._spmd_heads_per_shard = r.gauge(
            "mxtpu_llm_spmd_kv_heads_per_shard",
            "KV heads resident on each tp shard of the paged pool "
            "(num_heads / tp).", lbl).labels(**s)
        self._weight_dtype = r.gauge(
            "mxtpu_llm_weight_dtype",
            "Serving weight storage dtype (one series per dtype, "
            "value 1 on the active one; set at engine construction).",
            ("server", "dtype"))
        self._weight_dtype_children = {}
        self._weight_bytes = r.gauge(
            "mxtpu_llm_weight_bytes",
            "Device-resident bytes of the serving weight tree "
            "(quantized leaves + f32 scales + untouched leaves).",
            lbl).labels(**s)
        self._weight_params_per_chip = r.gauge(
            "mxtpu_llm_weight_params_per_chip",
            "Model parameters resident per chip (total params / tp) — "
            "with mxtpu_llm_weight_bytes this prices params-per-chip "
            "at each weight dtype.", lbl).labels(**s)
        self._quant_fallbacks = r.counter(
            "mxtpu_llm_quant_fallback_total",
            "fp8 weight/KV requests served as int8 because the "
            "backend lacks float8_e4m3fn (availability-guard "
            "fallbacks).", lbl).labels(**s)
        # the overload/failure series share the single-shot server's
        # mxtpu_serving_* catalog (one dashboard for both front ends)
        self._overload = OverloadStats(r, self._server)
        self._tenants = TenantStats(
            r, "mxtpu_llm_tenant_requests_total", self._server,
            tokens_metric="mxtpu_llm_tenant_tokens_total")
        self._evict_children = {}
        self._lock = threading.Lock()
        self._reset_label()

    def _reset_label(self):
        """Zero this label's children: a name re-claimed from a
        garbage-collected holder starts from 0, so ``snapshot()`` counts
        this instance's traffic only."""
        for metric in self._reg.metrics():
            if not metric.name.startswith(("mxtpu_llm_",
                                           "mxtpu_serving_")):
                continue
            for child in metric.children():
                if child.labels_dict.get("server") == self._server:
                    child.reset()

    @property
    def server_label(self):
        return self._server

    # ---------------------------------------------------- recording --
    def _labeled_child(self, counter, cache, **labels):
        """Memoized per-label child lookup (engine-thread only — the
        lock-free twin of TenantStats' guarded cache); one copy so the
        eviction-reason and tenant-saved series cannot drift."""
        key = tuple(sorted(labels.items()))
        child = cache.get(key)
        if child is None:
            child = counter.labels(server=self._server, **labels)
            cache[key] = child
        return child

    def record_submit(self):
        self._submitted.inc()

    def record_admission_state(self, waiting, running):
        self._queue_depth.set(waiting)
        self._running.set(running)

    def record_blocks(self, in_use, total, cached=0, shared=0,
                      free=None):
        self._blocks_in_use.set(in_use)
        self._blocks_total.set(total)
        self._blocks_cached.set(cached)
        self._blocks_shared.set(shared)
        self._blocks_free.set(total - in_use - cached
                              if free is None else free)

    def record_prefix_lookup(self, hit_tokens, tenant=None):
        """One admission-time prefix-cache lookup: counts the lookup,
        the hit (when any tokens were served from cache) and the
        prefill tokens saved — attributed per tenant when tagged."""
        self._prefix_lookups.inc()
        if hit_tokens > 0:
            self._prefix_hits.inc()
            self._prefill_saved.inc(hit_tokens)
            if tenant is not None:
                self._labeled_child(
                    self._tenant_saved, self._tenant_saved_children,
                    tenant=str(tenant)).inc(hit_tokens)

    def record_prefix_evict(self, n=1):
        self._prefix_evicts.inc(n)

    def record_prefill(self, prompt_tokens):
        self._prefills.inc()
        self._prefill_tokens.inc(prompt_tokens)

    def record_first_token(self, ttft_s, exemplar=None):
        """``exemplar`` (optional ``(req, span_id)``): keep this
        observation in its TTFT bucket's bounded reservoir — built by
        call sites only while the flight recorder is on."""
        self._ttft.observe(ttft_s, exemplar=exemplar)

    # smoothing factor for the per-step throughput EMA: heavy enough
    # to damp single-launch jitter, light enough that the gauge tracks
    # a load change within a few steps. A lifetime average would decay
    # toward zero across idle gaps and misreport healthy bursts.
    _TPS_ALPHA = 0.2

    def record_decode_step(self, new_tokens, step_s):
        with self._lock:
            self._decode_steps.inc()
            self._step_time.observe(step_s)
            self._tokens.inc(new_tokens)
            inst = new_tokens / max(step_s, 1e-9)
            prev = self._tps.value
            self._tps.set(inst if prev == 0
                          else prev + self._TPS_ALPHA * (inst - prev))

    def record_prefill_token(self):
        """The first generated token comes out of prefill, not a
        decode step — count it so the token counter sees every
        token (the throughput EMA tracks decode launches only)."""
        self._tokens.inc()

    def record_prefill_chunk(self, tokens):
        self._prefill_chunks.inc()
        self._prefill_chunk_tokens.inc(tokens)

    def record_spec(self, proposed, accepted):
        self._spec_proposed.inc(proposed)
        self._spec_accepted.inc(accepted)
        total = self._spec_proposed.value
        if total > 0:
            self._spec_accept_rate.set(
                self._spec_accepted.value / total)

    def record_spec_degraded(self):
        self._spec_degraded.inc()

    def record_preemption(self):
        self._preemptions.inc()

    def record_completed(self, latency_s, exemplar=None):
        self._completed.inc()
        self._latency.observe(latency_s, exemplar=exemplar)

    def record_evicted(self, reason):
        self._labeled_child(self._evicted, self._evict_children,
                            reason=reason).inc()

    def record_failure(self, n=1):
        self._failed.inc(n)

    # ------------------------------------------------ adapter series --
    def record_adapters_resident(self, n):
        self._adapters_resident.set(n)

    def record_adapter_evicted(self, reason, n=1):
        self._labeled_child(self._adapter_evictions,
                            self._adapter_evict_children,
                            reason=str(reason)).inc(n)

    def record_adapter_request(self, adapter, tenant=None):
        """One generation admitted under ``adapter`` — attributed per
        tenant too when the request is tenant-tagged."""
        self._labeled_child(self._adapter_requests,
                            self._adapter_req_children,
                            adapter=str(adapter)).inc()
        if tenant is not None:
            self._labeled_child(self._tenant_adapter_requests,
                                self._tenant_adapter_children,
                                tenant=str(tenant),
                                adapter=str(adapter)).inc()

    def record_adapter_publish(self, n=1):
        self._adapter_publishes.inc(n)

    # --------------------------------------------- quantized weights --
    def record_weight_quant(self, dtype, weight_bytes,
                            params_per_chip):
        """Engine construction: publish the serving weight dtype (a
        1-valued series per dtype label — float32 engines publish too,
        so dashboards can diff a mixed fleet), resident weight bytes
        and the params-per-chip headline."""
        self._labeled_child(self._weight_dtype,
                            self._weight_dtype_children,
                            dtype=str(dtype)).set(1)
        self._weight_bytes.set(int(weight_bytes))
        self._weight_params_per_chip.set(int(params_per_chip))

    def record_quant_fallback(self, n=1):
        """One fp8→int8 availability-guard fallback (weights or KV)."""
        self._quant_fallbacks.inc(n)

    # ------------------------------------------------- tenant series --
    def record_tenant(self, tenant, outcome, n=1):
        """Per-tenant outcome attribution (no-op for tenant None)."""
        self._tenants.record(tenant, outcome, n)

    def record_tenant_tokens(self, tenant, n):
        self._tenants.record_tokens(tenant, n)

    # ------------------------------------------------ overload series --
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
            return self._overload.snapshot_into({
                "requests_submitted": int(self._submitted.value),
                "requests_completed": int(self._completed.value),
                "requests_evicted": int(sum(
                    c.value for c in self._evict_children.values())),
                "requests_failed": int(self._failed.value),
                "tokens_generated": int(self._tokens.value),
                "prefill_tokens": int(self._prefill_tokens.value),
                "prefills": int(self._prefills.value),
                "prefill_chunks": int(self._prefill_chunks.value),
                "prefill_chunk_tokens": int(
                    self._prefill_chunk_tokens.value),
                "spec_proposed": int(self._spec_proposed.value),
                "spec_accepted": int(self._spec_accepted.value),
                "spec_degraded": int(self._spec_degraded.value),
                "spec_accept_rate": self._spec_accept_rate.value,
                "decode_steps": int(self._decode_steps.value),
                "preemptions": int(self._preemptions.value),
                "queue_depth": int(self._queue_depth.value),
                "running_seqs": int(self._running.value),
                "kv_blocks_in_use": int(self._blocks_in_use.value),
                "kv_blocks_total": int(self._blocks_total.value),
                "kv_blocks_cached": int(self._blocks_cached.value),
                "kv_blocks_shared": int(self._blocks_shared.value),
                "kv_blocks_free": int(self._blocks_free.value),
                "prefix_lookups": int(self._prefix_lookups.value),
                "prefix_hits": int(self._prefix_hits.value),
                "prefix_evictions": int(self._prefix_evicts.value),
                "prefill_tokens_saved": int(
                    self._prefill_saved.value),
                "tokens_per_sec": self._tps.value,
                "ttft_ms": {
                    "p50": self._ttft.percentile(50) * 1e3,
                    "p99": self._ttft.percentile(99) * 1e3,
                },
                "request_ms": {
                    "p50": self._latency.percentile(50) * 1e3,
                    "p99": self._latency.percentile(99) * 1e3,
                },
                "weight_dtype": {
                    k[0][1]: int(c.value) for k, c in
                    self._weight_dtype_children.items()},
                "weight_bytes": int(self._weight_bytes.value),
                "weight_params_per_chip": int(
                    self._weight_params_per_chip.value),
                "quant_fallbacks": int(self._quant_fallbacks.value),
                "adapters_resident": int(
                    self._adapters_resident.value),
                "adapter_publishes": int(
                    self._adapter_publishes.value),
                "adapter_evictions": {
                    k[0][1]: int(c.value) for k, c in
                    self._adapter_evict_children.items()},
                "adapter_requests": {
                    k[0][1]: int(c.value) for k, c in
                    self._adapter_req_children.items()},
                # keys sort as (adapter, tenant)
                "tenant_adapter_requests": {
                    f"{k[1][1]}/{k[0][1]}": int(c.value) for k, c in
                    self._tenant_adapter_children.items()},
                "tenants": self._tenants.snapshot(),
            })

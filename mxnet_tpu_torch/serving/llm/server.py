"""LLMServer: the request-facing front end of the decode engine (the
port of ``mxnet_tpu/serving/llm/server.py``, one engine on one device).

Many threads submit prompts and get Futures; ONE worker thread drives
the engine loop (admit → step → retire, every iteration); ``warmup()``
builds every kernel the steps launch and, on CUDA, captures the step's
graph at every rung (and the draft's at every rung of its ladder)
before serving begins (``stats()["compiles"]``
counts both and must not move after it); drain on shutdown resolves
EVERY Future and then releases the engine's graphs.

Drain semantics: an in-flight sequence is minutes of state, so drain
runs the engine until every live sequence completes OR a deadline
(``deadline_ms`` arg > ``MXNET_TPU_SERVE_DRAIN_DEADLINE_MS`` env >
unbounded) expires — past it, live sequences are rejected with a typed
:class:`SequenceEvictedError` CARRYING the tokens generated so far.

Overload & failure semantics:

- ``submit(..., deadline_ms=)`` (env ``MXNET_TPU_SERVE_DEADLINE_MS``)
  puts an END-TO-END deadline on the generation: expired while waiting
  → failed before any prefill; expired mid-decode → evicted with
  partial tokens; both resolve with a typed
  :class:`~..errors.DeadlineExceededError`;
- admission is bounded (``MXNET_TPU_SERVE_MAX_QUEUE`` counts pending +
  waiting sequences); past the bound ``submit`` sheds with a typed
  :class:`~..errors.Overloaded`;
- ``generate(..., timeout=)`` CANCELS the underlying sequence on
  timeout: its KV blocks and slot are released and the Future resolves
  typed;
- poison decode rows (bisect isolation in the engine) fail ONLY their
  own Future, with the original exception; persistent dispatch failures
  trip the :class:`~..overload.CircuitBreaker` and submits fail fast
  with :class:`~..errors.CircuitOpenError` until a half-open probe
  heals;
- a dying worker writes a flight bundle (``crash_dump``, while the
  dying state is visible), then resolves every live Future and frees
  every KV block before the thread exits.

Lifecycle: :meth:`LLMServer.quiesce` stops admission and waits for every
admitted Future while the worker, the pools and the captured graphs stay
warm; :meth:`LLMServer.resume` re-opens admission;
:meth:`LLMServer.attach_preemption_guard` drains on a
:class:`~mxnet_tpu_torch.resilience.PreemptionGuard`'s signal.

Observability: a per-request hand-off span (``mxtpu.llm.request``) opened
at submit under the caller's context and finished at resolution, the
engine's step spans, the flight recorder's request events
(``llm.submit`` / ``llm.shed`` / ``llm.served`` / ``llm.evicted`` /
``llm.expired`` / ``llm.poisoned``, and ``breaker`` transitions), the
statusz surface (:meth:`LLMServer.debug_status`, registered with the
recorder as ``llm:<name>``) and the ``mxtpu_llm_*`` /
``mxtpu_serving_*`` registry series. The worker loop carries the
``llm.worker`` fault site.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, TimeoutError as FuturesTimeout

import numpy as np

from ..envutil import env_float as _env_float
from ..errors import (DeadlineExceededError, Overloaded,
                      SequenceEvictedError, ServerClosed)
from ..adapters.bank import UnknownAdapterError
from ..overload import (CircuitBreaker, resolve_deadline,
                        resolve_overload_knobs, shed_if_breaker_open)
from ..telemetry import compile_count
from ...observability.flightrecorder import get_flightrecorder
from ...observability.tracing import get_tracer
from ...resilience import faults
from .engine import LLMEngine
from .metrics import LLMStats
from .sampling import SamplingParams
from .scheduler import Sequence

__all__ = ["LLMServer", "SequenceEvictedError", "GenerationResult"]


class GenerationResult:
    """A completed generation: ``tokens`` (ints, prompt excluded),
    ``seq_id``, ``ttft_s``, ``finish_reason``."""

    __slots__ = ("tokens", "seq_id", "ttft_s", "finish_reason")

    def __init__(self, tokens, seq_id, ttft_s, finish_reason):
        self.tokens = tokens
        self.seq_id = seq_id
        self.ttft_s = ttft_s
        self.finish_reason = finish_reason

    def __repr__(self):
        return (f"GenerationResult(seq={self.seq_id}, "
                f"tokens={len(self.tokens)}, "
                f"reason={self.finish_reason!r})")


class LLMServer:
    """Serve autoregressive decoding (greedy or sampled) with
    continuous batching on one device.

    ``model``/``params``: a :class:`~.model.TinyDecoder` and its param
    tree (or a :class:`~.quant.QuantizedWeights`). Engine kwargs
    (``max_seqs``, ``block_size``, ``num_blocks``, ``max_context``,
    ``prefill_chunk``, ``dtype``, ``kv_dtype``, ``weight_dtype``,
    ``prefix_cache``, ``device``, ``draft_model`` / ``draft_params``
    / ``spec_k`` / ``draft_weight_dtype`` for speculative decoding, and
    ``adapter_bank`` for multi-LoRA serving) pass through to
    :class:`~.engine.LLMEngine`. Overload knobs: ``max_queue``
    (``MXNET_TPU_SERVE_MAX_QUEUE``), ``deadline_ms``
    (``MXNET_TPU_SERVE_DEADLINE_MS``), ``breaker_threshold`` /
    ``breaker_cooldown_ms`` (``MXNET_TPU_SERVE_BREAKER_*``).
    """

    def __init__(self, model, params, name="llm", max_queue=None,
                 deadline_ms=None, breaker_threshold=None,
                 breaker_cooldown_ms=None, **engine_kw):
        self.name = name
        self._stats = LLMStats(server=name)
        self._flight = get_flightrecorder()
        self._breaker = CircuitBreaker(
            threshold=breaker_threshold,
            cooldown_ms=breaker_cooldown_ms,
            on_state=self._on_breaker_state)
        self._engine = LLMEngine(model, params, stats=self._stats,
                                 breaker=self._breaker, **engine_kw)
        # one engine: the reference's dp replica groups arrive with the
        # tensor-parallel step (ROADMAP.md §1 item 9)
        self.dp = 1
        self.max_queue, self.default_deadline_ms = \
            resolve_overload_knobs(max_queue, deadline_ms)
        self._cv = threading.Condition()
        self._pending = []            # guarded-by: _cv
        self._closed = False          # guarded-by: _cv
        self._drain = True            # guarded-by: _cv
        self._deadline = None         # guarded-by: _cv
        # quiesce/resume: an admission gate and the exact count of live
        # Futures (done-callbacks), so the gap between popping _pending
        # and engine.add() can never look drained
        self._quiesced = False        # guarded-by: _cv
        self._live = 0                # guarded-by: _cv
        self._worker = None
        self._started = False
        self._guard_watcher = None
        self._guard_stop = threading.Event()
        self._flight.register(f"llm:{name}", self)

    def _on_breaker_state(self, state):
        """Breaker transition: the gauge and one flight control-plane
        event."""
        self._stats.record_breaker_state(state)
        fl = self._flight
        if fl.enabled:
            fl.event("breaker", attrs={"server": self.name,
                                       "state": state})

    @property
    def engine(self):
        return self._engine

    @property
    def max_context(self):
        return self._engine.max_context

    # ----------------------------------------------------- lifecycle --
    def start(self):
        if self._started:
            return self
        self._started = True
        self._worker = threading.Thread(
            target=self._run_loop, name=f"mxt-{self.name}-engine",
            daemon=True)
        self._worker.start()
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
        return False

    @property
    def running(self):
        with self._cv:
            return self._started and not self._closed

    def warmup(self):
        """Build (on CUDA: capture) and run every step rung once, so no
        kernel is built and no graph captured while serving. Must run BEFORE ``start()`` — the engine thread owns
        the KV pools once serving begins. Returns {rung: seconds}."""
        if self._started:
            raise RuntimeError(
                "warmup() must run before start(): the engine thread "
                "owns the KV cache once serving begins")
        return self._engine.warmup()

    # -------------------------------------------------------- submit --
    def _queue_depth(self):   # guarded-by: caller
        """Admission backlog: sequences holding NO KV blocks yet."""
        return len(self._pending) + self._engine.scheduler.num_waiting

    def submit(self, prompt_tokens, max_new_tokens, stop_token=None,
               deadline_ms=None, tenant=None, sampling=None,
               adapter=None):
        """Enqueue one prompt; returns a Future resolving to a
        :class:`GenerationResult` (or raising a typed
        :class:`~..errors.ServingError` subclass; at submit time
        :class:`Overloaded` / :class:`CircuitOpenError`).

        ``sampling``: a :class:`~.sampling.SamplingParams` or a dict of
        its kwargs (default greedy). ``tenant`` attributes this
        generation's outcome and tokens per tenant.

        ``adapter``: the name of a published LoRA adapter to decode
        under (``None``: the base model). It needs an
        :class:`~..adapters.AdapterBank` on the engine (``adapter_bank=``)
        and a resident name, checked here on the caller's thread
        (``ValueError`` without a bank, :class:`UnknownAdapterError` for
        an unknown name), so a typo raises at submit, not mid-batch. The
        adapter rides the step's batch as data: mixed-adapter packs and
        base-model rows run in the same captured graphs."""
        if isinstance(sampling, dict):
            sampling = SamplingParams(**sampling)
        if not self._started:
            raise RuntimeError("server not started; call start()")
        if adapter is not None:
            bank = self._engine.bank
            if bank is None:
                raise ValueError(
                    f"adapter={adapter!r} but the engine has no "
                    "AdapterBank (pass adapter_bank= at construction)")
            if not bank.known(adapter):
                raise UnknownAdapterError(
                    f"adapter {adapter!r} is not resident in the bank")
        try:
            shed_if_breaker_open(self._breaker, self._stats)
            deadline = resolve_deadline(deadline_ms,
                                        self.default_deadline_ms,
                                        self._stats)
        except Overloaded:              # breaker_open shed
            self._stats.record_tenant(tenant, "shed")
            self._shed_event(tenant, "breaker_open")
            raise
        except DeadlineExceededError:   # budget spent at submit
            self._stats.record_tenant(tenant, "expired")
            self._shed_event(tenant, "deadline_at_submit")
            raise
        prompt = [int(t) for t in np.asarray(prompt_tokens).ravel()]
        seq = Sequence(prompt, max_new_tokens, stop_token=stop_token,
                       deadline=deadline, tenant=tenant,
                       sampling=sampling, adapter=adapter)
        # validate shape/vocab NOW, on the caller's thread
        self._engine.add_validate(seq)
        seq.future = Future()
        seq.future._mxt_seq = seq          # generate-timeout cancel hook
        tracer = get_tracer()
        if tracer.enabled:
            seq.span = tracer.begin("mxtpu.llm.request", "llm",
                                    tracer.current())
            seq.span.set("seq_id", seq.seq_id)
            seq.span.set("prompt", len(prompt))
        with self._cv:
            if self._closed:
                self._close_span(seq, error="ServerClosed")
                self._shed_event(tenant, "closed")
                raise ServerClosed(
                    "server is draining; no new sequences admitted")
            if self._quiesced:
                self._close_span(seq, error="ServerClosed")
                self._shed_event(tenant, "quiesced")
                raise ServerClosed(
                    "server is quiesced; admission paused "
                    "(resume() re-opens)")
            if (self.max_queue is not None
                    and self._queue_depth() >= self.max_queue):
                depth = self._queue_depth()
                self._stats.record_shed("queue_full")
                self._stats.record_tenant(tenant, "shed")
                self._close_span(seq, error="Overloaded")
                self._shed_event(tenant, "queue_full", depth=depth)
                raise Overloaded(
                    f"admission queue full ({depth} >= max_queue "
                    f"{self.max_queue}); request shed",
                    reason="queue_full", depth=depth)
            self._pending.append(seq)
            self._live += 1
            self._cv.notify_all()
        seq.future.add_done_callback(self._live_dec)
        self._stats.record_submit()
        self._stats.record_tenant(tenant, "submitted")
        fl = self._flight
        if fl.enabled:
            fl.event("llm.submit", req=f"llm:{seq.seq_id}",
                     tenant=tenant,
                     attrs={"server": self.name, "prompt": len(prompt),
                            "adapter": adapter,
                            "span_id": seq.span.span_id
                            if seq.span is not None else None})
        return seq.future

    def _shed_event(self, tenant, reason, **attrs):
        fl = self._flight
        if fl.enabled:
            fl.event("llm.shed", tenant=tenant,
                     attrs={"server": self.name, "reason": reason,
                            **attrs})

    def cancel(self, future):
        """Cancel the sequence behind a Future from :meth:`submit`: the
        engine releases its KV blocks and slot at the next iteration
        and the Future resolves with a typed
        :class:`DeadlineExceededError` (``reason="timeout"``) carrying
        the tokens so far. Returns False if already resolved."""
        seq = getattr(future, "_mxt_seq", None)
        if seq is None or future.done():
            return False
        with self._cv:
            seq.cancelled = True
            self._cv.notify_all()
        return True

    def generate(self, prompt_tokens, max_new_tokens, stop_token=None,
                 timeout=None, deadline_ms=None, reap_timeout=5.0,
                 tenant=None, sampling=None, adapter=None):
        """Blocking single-prompt decode through the batcher. On
        ``timeout`` the sequence is CANCELLED (its KV blocks and slot
        are released) and the typed :class:`DeadlineExceededError`
        (with partial tokens) is raised; ``reap_timeout`` bounds the
        wait for the engine to resolve the cancel."""
        fut = self.submit(prompt_tokens, max_new_tokens,
                          stop_token=stop_token, deadline_ms=deadline_ms,
                          tenant=tenant, sampling=sampling, adapter=adapter)
        try:
            return fut.result(timeout=timeout)
        except FuturesTimeout:
            self.cancel(fut)
            try:
                return fut.result(timeout=reap_timeout)
            except FuturesTimeout:
                seq = fut._mxt_seq
                raise DeadlineExceededError(
                    "generation cancelled on timeout but not yet "
                    "reaped by the engine", tokens=seq.output_tokens(),
                    seq_id=seq.seq_id, reason="timeout") from None

    # --------------------------------------------------------- stats --
    def stats(self):
        eng = self._engine
        snap = self._stats.snapshot()
        snap["compiles"] = compile_count()
        snap["programs"] = eng.programs()
        snap["kv_cache"] = eng.cache.stats()
        snap["prefill_chunk"] = eng.prefill_chunk
        snap["spec_k"] = eng.spec_k
        snap["q_tokens"] = eng.q_tokens
        snap["max_seqs"] = eng.max_seqs
        snap["prefix_cache"] = eng.prefix_enabled
        snap["kv_dtype"] = eng.cache.dtype_name
        snap["weight_dtype"] = eng.weight_dtype
        snap["draft_weight_dtype"] = eng.draft_weight_dtype
        snap["weight_bytes"] = eng.weight_bytes
        snap["weight_params_per_chip"] = eng.weight_params
        lookups = snap["prefix_lookups"]
        snap["prefix_hit_rate"] = (snap["prefix_hits"] / lookups
                                   if lookups else 0.0)
        snap["device"] = str(eng.device)
        if eng.bank is not None:
            snap["adapters"] = eng.bank.stats()
        return snap

    def debug_status(self):
        """Live state for the flight recorder's statusz surface:
        admission and lifecycle flags read under the server lock, and
        the engine's :meth:`~.engine.LLMEngine.debug_status`. JSON-ready
        and free of side effects, so a dump may call it while the
        worker is dying."""
        with self._cv:
            pending = len(self._pending)
            closed, quiesced = self._closed, self._quiesced
            live = self._live
        return {
            "kind": "llm",
            "server": self.name,
            "started": self._started,
            "closed": closed,
            "quiesced": quiesced,
            "live_futures": live,
            "pending": pending,
            "queue_depth": pending + self._engine.scheduler.num_waiting,
            "max_queue": self.max_queue,
            "breaker_state": self._breaker.state,
            "dp": self.dp,
            "mesh": None,
            "engine": self._engine.debug_status(),
        }

    # --------------------------------------------------------- drain --
    def shutdown(self, drain=True, deadline_ms=None):
        """Stop admitting. With ``drain``, run every live sequence to
        completion within the deadline (explicit ``deadline_ms`` >
        ``MXNET_TPU_SERVE_DRAIN_DEADLINE_MS`` env > unbounded); past it
        — or immediately with ``drain=False`` — live sequences resolve
        with :class:`SequenceEvictedError` carrying their tokens so
        far. Idempotent; every Future resolves either way. The engine's
        graphs are released once the worker has stopped."""
        if not self._started:
            return
        if deadline_ms is None:
            env_ms = _env_float("MXNET_TPU_SERVE_DRAIN_DEADLINE_MS", 0.0)
            deadline_ms = env_ms if env_ms > 0 else None
        with self._cv:
            if not self._closed:
                self._closed = True
                self._drain = bool(drain)
                if not drain:
                    self._deadline = time.monotonic()
                elif deadline_ms is None:
                    self._deadline = None
                else:
                    self._deadline = (time.monotonic()
                                      + deadline_ms / 1e3)
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join()
        self._guard_stop.set()
        self._engine.release_graphs()

    close = shutdown

    # ------------------------------------------------------- quiesce --
    def _live_dec(self, _fut=None):
        """Done-callback: one admitted generation's Future resolved."""
        with self._cv:
            self._live -= 1
            self._cv.notify_all()

    def quiesce(self, timeout=None):
        """Stop admitting NEW sequences and wait until every admitted
        Future has resolved (any typed outcome). Unlike :meth:`shutdown`
        the worker, the KV pools and the captured graphs stay warm:
        :meth:`resume` re-opens admission without building or capturing
        anything. While quiesced, ``submit`` raises
        :class:`ServerClosed`.

        Returns True once drained; False if ``timeout`` (seconds)
        expired with sequences still live. The server stays quiesced
        either way; the caller picks :meth:`resume` or :meth:`shutdown`
        (whose drain evicts stragglers typed, with partial tokens)."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        with self._cv:
            self._quiesced = True
            while self._live > 0:
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    return False
                self._cv.wait(rem if rem is not None else 0.5)
            return True

    def resume(self):
        """Re-open admission after :meth:`quiesce`. Idempotent."""
        with self._cv:
            self._quiesced = False

    @property
    def admitting(self):
        with self._cv:
            return not self._quiesced and not self._closed

    def attach_preemption_guard(self, guard, poll_s=0.05,
                                deadline_ms=None):
        """Drain on preemption: once ``guard`` (a
        :class:`~mxnet_tpu_torch.resilience.PreemptionGuard`) trips, a
        watcher thread stops admission and drains under
        ``deadline_ms``; sequences that cannot finish in time are
        evicted WITH their partial tokens. Returns the server."""
        if self._guard_watcher is not None:
            return self

        def _watch():
            while not self._guard_stop.is_set():
                if guard.wait(poll_s):
                    self.shutdown(drain=True, deadline_ms=deadline_ms)
                    return

        self._guard_watcher = threading.Thread(
            target=_watch, name=f"mxt-{self.name}-preempt-watch",
            daemon=True)
        self._guard_watcher.start()
        return self

    # --------------------------------------------------- worker loop --
    def _close_span(self, seq, **attrs):
        if seq.span is not None:
            for k, v in attrs.items():
                seq.span.set(k, v)
            seq.span.finish()
            seq.span = None

    def _resolve_finished(self, seq):
        ttft = (seq.t_first_token - seq.t_submit
                if seq.t_first_token else None)
        res = GenerationResult(seq.output_tokens(), seq.seq_id, ttft,
                               seq.finish_reason)
        latency = time.monotonic() - seq.t_submit
        ex = None
        fl = self._flight
        if fl.enabled:
            key = f"llm:{seq.seq_id}"
            ex = (key, seq.span.span_id if seq.span is not None else None)
            fl.event("llm.served", req=key, tenant=seq.tenant,
                     attrs={"server": self.name,
                            "tokens": len(res.tokens),
                            "finish": seq.finish_reason,
                            "latency_ms": round(latency * 1e3, 3),
                            "ttft_ms": round(ttft * 1e3, 3)
                            if ttft is not None else None})
        self._stats.record_completed(latency, exemplar=ex)
        self._stats.record_tenant(seq.tenant, "served")
        self._stats.record_tenant_tokens(seq.tenant, len(res.tokens))
        span_attrs = {"tokens": len(res.tokens)}
        if ttft is not None:
            span_attrs["ttft_ms"] = round(ttft * 1e3, 3)
        self._close_span(seq, finish=seq.finish_reason, **span_attrs)
        seq.future.set_result(res)

    def _lifecycle_event(self, kind, seq, **attrs):
        fl = self._flight
        if fl.enabled:
            fl.event(kind, req=f"llm:{seq.seq_id}", tenant=seq.tenant,
                     attrs={"server": self.name, **attrs})

    def _resolve_evicted(self, seq, reason):
        toks = seq.output_tokens()
        self._stats.record_evicted(reason)
        self._stats.record_tenant(seq.tenant, "evicted")
        self._stats.record_tenant_tokens(seq.tenant, len(toks))
        self._lifecycle_event("llm.evicted", seq, reason=reason,
                              tokens=len(toks))
        self._close_span(seq, error=reason, tokens=len(toks))
        seq.future.set_exception(SequenceEvictedError(
            f"sequence {seq.seq_id} evicted ({reason}) after "
            f"{len(toks)} tokens", tokens=toks, seq_id=seq.seq_id,
            reason=reason))

    def _resolve_dead(self, seq, reason):
        """A deadline-expired ("deadline") or cancelled ("timeout")
        sequence: typed DeadlineExceededError with partial tokens."""
        toks = seq.output_tokens()
        if reason == "deadline":
            self._stats.record_deadline_expired()
        else:
            self._stats.record_evicted(reason)
        self._stats.record_tenant(seq.tenant, "expired")
        self._stats.record_tenant_tokens(seq.tenant, len(toks))
        self._lifecycle_event("llm.expired", seq, reason=reason,
                              tokens=len(toks))
        self._close_span(seq, error=reason, tokens=len(toks))
        seq.future.set_exception(DeadlineExceededError(
            f"sequence {seq.seq_id} {reason} after {len(toks)} tokens",
            tokens=toks, seq_id=seq.seq_id, reason=reason))

    def _resolve_poison(self, seq, exc):
        """A poison-isolated sequence fails with the ORIGINAL dispatch
        exception."""
        self._stats.record_failure()
        self._stats.record_tenant(seq.tenant, "failed")
        self._lifecycle_event("llm.poisoned", seq, error=repr(exc))
        self._close_span(seq, error=repr(exc))
        seq.future.set_exception(exc)

    def _flush_engine(self):
        eng = self._engine
        for seq in eng.pop_finished():
            self._resolve_finished(seq)
        for seq, reason in eng.pop_dead():
            self._resolve_dead(seq, reason)
        for seq, exc in eng.pop_poison():
            self._resolve_poison(seq, exc)

    def _fail_everything(self, exc):
        """Worker-death cleanup: resolve EVERY live Future (engine +
        still-pending) with a typed ServerClosed chaining the original
        death, and free every KV block."""
        with self._cv:
            self._closed = True
            self._drain = False
            orphans, self._pending = self._pending, []
        self._flush_engine()
        err = ServerClosed(f"llm engine worker died: {exc!r}")
        err.__cause__ = exc
        for seq in orphans + self._engine.evict_all("engine_error"):
            if seq.future.done():       # defensive: never double-set
                continue
            self._stats.record_failure()
            self._stats.record_tenant(seq.tenant, "failed")
            self._close_span(seq, error=repr(exc))
            seq.future.set_exception(err)

    def _run_loop(self):
        try:
            self._run_loop_inner()
        except BaseException as exc:
            # the flight bundle FIRST, while the dying state (queue
            # depths, live sequences, KV partition) is still visible;
            # crash_dump never raises. Then close admission so no submit
            # can enqueue onto a dead loop, and resolve every live Future
            self._flight.crash_dump(exc, server=self.name)
            self._fail_everything(exc)
            raise

    def _run_loop_inner(self):
        eng = self._engine
        while True:
            with self._cv:
                while (not self._pending and not eng.has_work()
                       and not self._closed):
                    self._cv.wait(timeout=0.05)
                pending, self._pending = self._pending, []
                closed, drain = self._closed, self._drain
                deadline = self._deadline
            for seq in pending:
                eng.add(seq)
            # chaos site: crash_at_point("llm.worker") kills the loop
            faults.point("llm.worker")
            if closed:
                expired = (deadline is not None
                           and time.monotonic() >= deadline)
                if not drain or expired:
                    reason = ("shutdown" if not drain
                              else "drain_deadline")
                    self._flush_engine()
                    for seq in eng.evict_all(reason):
                        self._resolve_evicted(seq, reason)
                    return
                if not eng.has_work():
                    self._flush_engine()
                    return
            if eng.has_work():
                eng.step()
            self._flush_engine()

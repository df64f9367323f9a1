"""ModelServer of the port (mirrors ``mxnet_tpu/serving/server.py``):
single-shot inference serving over one CUDA graph per shape bucket.

The runtime layer between "a trained gluon Block" and "heavy concurrent
traffic":

- many threads call :meth:`ModelServer.submit` (or the blocking
  :meth:`predict`) with ONE sample each;
- a single worker thread pops micro-batches from the
  :class:`~.batching.MicroBatchQueue` (max batch size + max queue
  delay), pads them to the nearest shape bucket (:mod:`~.bucketing`),
  and runs the model once per batch;
- a gluon ``Block`` is served from the server's own copy of its
  parameters, taken when the server is built (the reference's
  ``extract_params`` snapshot: a ``Trainer`` updating the block in place
  afterwards does not change what is served). On CUDA, :meth:`warmup`
  captures one CUDA graph per bucket (:func:`mxnet_tpu_torch.kernels.
  capture`, counted once each in :func:`~.telemetry.compile_count`, as
  the reference's first compile of a bucket); a batch is then one
  host-to-device copy, one ``replay()`` and one device-to-host copy. A
  bucket whose capture fails raises, naming the bucket; nothing steps
  eagerly on the card. On the CPU the same forward runs eagerly;
- :meth:`shutdown` (and the :class:`~mxnet_tpu_torch.resilience.
  PreemptionGuard` integration :meth:`attach_preemption_guard`) drains
  gracefully: close admission, flush the queue, resolve every in-flight
  Future, then exit and release the graphs.

Overload & failure semantics:

- **end-to-end deadlines** — ``submit(x, deadline_ms=...)`` (env
  default ``MXNET_TPU_SERVE_DEADLINE_MS``) rides on the request; one
  that expires while queued is failed with a typed
  :class:`~.errors.DeadlineExceededError` BEFORE wasting a dispatch,
  and batch assembly skips already-dead entries;
- **admission control** — a bounded queue
  (``MXNET_TPU_SERVE_MAX_QUEUE``) plus an estimated-wait check against
  the request's deadline budget (driven by the
  ``mxtpu_serving_service_seconds`` histogram); past either bound
  ``submit`` fails fast with a typed :class:`~.errors.Overloaded`
  (shed, counted by reason) instead of growing the queue;
- **poison isolation** — a failing batched dispatch is bisect-retried
  to isolate the poison row(s); only those Futures fail (with the
  ORIGINAL exception), the rest are served;
- **circuit breaker** — persistent dispatch failures trip a
  :class:`~.overload.CircuitBreaker`; while open, submits and queued
  batches are rejected typed (:class:`~.errors.CircuitOpenError`)
  until a half-open probe succeeds;
- **worker death** — if the worker loop dies (the fault point
  ``serving.worker``), every queued and in-flight request is failed
  with a typed ``ServerClosed`` before the thread exits. The invariant
  under every injected fault: every submitted Future resolves, with a
  result or a typed error.

Fault sites: ``serving.dispatch`` (before each model run) and
``serving.worker`` (each popped batch). Tracer spans
``mxtpu.serving.{request,batch,pad,dispatch,reply,isolate}``; flight
events ``serving.{submit,shed,served,expired,poisoned,breaker_reject}``
and ``breaker``.

Config resolution order: constructor arg > ``MXNET_TPU_SERVE_*`` env var
> default. Env vars: ``MXNET_TPU_SERVE_MAX_BATCH`` (8),
``MXNET_TPU_SERVE_MAX_DELAY_MS`` (2.0), ``MXNET_TPU_SERVE_BUCKETS``
(comma-separated, default powers of two up to max batch),
``MXNET_TPU_SERVE_MAX_QUEUE`` (0 = unbounded),
``MXNET_TPU_SERVE_DEADLINE_MS`` (0 = none),
``MXNET_TPU_SERVE_BREAKER_THRESHOLD`` (5),
``MXNET_TPU_SERVE_BREAKER_COOLDOWN_MS`` (1000),
``MXNET_TPU_SERVE_EVENT_LOG`` (JSONL path, off by default).
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np

from .batching import MicroBatchQueue, Request
from .bucketing import BucketSpec, bucket_sizes, waste_fraction
from .errors import (CircuitOpenError, DeadlineExceededError, Overloaded,
                     ServerClosed)
from .overload import (CircuitBreaker, resolve_deadline,
                       resolve_overload_knobs, shed_if_breaker_open)
from .telemetry import ServingStats, EventLog, compile_count
from ..observability.tracing import get_tracer
from ..observability.flightrecorder import get_flightrecorder
from ..resilience import faults

__all__ = ["ModelServer", "ServerClosed"]


def _is_predictor(model):
    """A ``deploy.Predictor``-shaped object (a serialized program with a
    fixed or batch-polymorphic input)."""
    return all(hasattr(model, a) for a in ("predict", "poly_batch",
                                           "input_shape"))


class _Graph:
    """One bucket's captured forward: its static input buffer, its
    output (in the graph's pool) and the graph."""

    __slots__ = ("x", "out", "graph")

    def __init__(self, x, out, graph):
        self.x = x
        self.out = out
        self.graph = graph


class _BlockBackend:
    """``fn(np (b, *item)) -> np (b, *out)`` over a gluon ``Block``: the
    port of the reference's ``jax.jit(functional_call)`` per bucket.

    The parameters are cloned when the backend is made and the forward
    reads the clones (:func:`~mxnet_tpu_torch.gluon.parameter.
    param_values`), as the reference's ``functional_call`` reads the
    snapshot it was given: a ``Trainer`` that updates the block in place
    later does not change what is served. The forward runs under
    ``autograd.pause(train_mode=False)`` and ``torch.no_grad()``.

    On CUDA each input shape (one per bucket) is one CUDA graph, captured
    at its first run (``warmup`` runs every bucket) over a static input
    buffer; a call is a host-to-device copy into that buffer, one
    ``replay()`` and a device-to-host copy of the graph's output. A
    failed capture raises :class:`~mxnet_tpu_torch.kernels.CaptureError`
    naming the bucket. On the CPU the forward runs eagerly."""

    def __init__(self, block, name):
        import torch
        from ..gluon.parameter import DeferredInitializationError
        try:
            self._values = {p: p.data().detach().clone()
                            for p in block.collect_params().values()}
        except DeferredInitializationError as exc:
            raise RuntimeError(
                "cannot serve a block whose parameter shapes are still "
                "deferred: run one forward first, or build the server "
                "through Block.serve(example_input=...)") from exc
        devices = {t.device for t in self._values.values()}
        if len(devices) > 1:
            raise ValueError(f"the block's parameters are on several "
                             f"devices: {sorted(map(str, devices))}")
        self.device = devices.pop() if devices else torch.device("cpu")
        self._block = block
        self._name = name
        self._lock = threading.Lock()
        self._graphs = {}           # guarded-by: _lock (for inserts)
        self._stream = None
        self._pool = None
        self.capture_seconds = {}   # bucket -> seconds
        self.replays = 0
        self.runs = 0

    def _forward(self, x):
        import torch
        from .. import autograd
        from ..gluon.parameter import param_values
        with autograd.pause(train_mode=False), torch.no_grad(), \
                param_values(self._values):
            out = self._block(x)
        if not isinstance(out, torch.Tensor):
            raise TypeError(
                f"a served block must return one tensor, got "
                f"{type(out).__name__}; wrap it in a Block whose forward "
                "returns the output to serve")
        return out

    def _capture(self, shape, dtype):
        import torch
        from .. import kernels
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        x = torch.zeros(shape, dtype=dtype, device=self.device)
        held = {}

        def step():
            held["out"] = self._forward(x)
        t0 = time.monotonic()
        graph = kernels.capture(
            step, self._stream, self._pool,
            what=f"server {self._name!r}'s bucket {shape[0]} (input "
                 f"{tuple(shape)} {dtype})")
        self.capture_seconds[shape[0]] = time.monotonic() - t0
        return _Graph(x, held["out"], graph)

    def _graph(self, shape, dtype):
        key = (tuple(shape), dtype)
        g = self._graphs.get(key)
        if g is None:
            with self._lock:
                g = self._graphs.get(key)
                if g is None:
                    g = self._graphs[key] = self._capture(shape, dtype)
        return g

    def __call__(self, batch):
        import torch
        x = torch.from_numpy(np.ascontiguousarray(batch))
        self.runs += 1
        if self.device.type != "cuda":
            return self._forward(x.to(self.device)).numpy()
        g = self._graph(x.shape, x.dtype)
        g.x.copy_(x)
        g.graph.replay()
        self.replays += 1
        return g.out.cpu().numpy()

    @property
    def graphs(self):
        return len(self._graphs)

    def graph_pool_bytes(self):
        """Device bytes the graphs' memory pool holds (0 on the CPU or
        with no graph held)."""
        if self._pool is None:
            return 0
        import torch
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def release(self):
        """Drop every graph and the pool; a later call captures again."""
        with self._lock:
            self._graphs = {}
            self._stream = self._pool = None


def _finish_request_spans(batch, bucket=None, pad_s=None, service_s=None,
                          error=None):
    """Close each request's hand-off span with the latency decomposition
    (queue → pad → compute, in ms) and its request id, so one serving
    request reads end to end in an exported trace. No-ops when tracing
    is off (the spans are the _NULL singleton)."""
    for req in batch:
        sp = req.span
        if sp is None:
            continue
        sp.set("req_id", req.rid)
        sp.set("queue_ms", round(req.wait_s * 1e3, 3))
        if bucket is not None:
            sp.set("bucket", bucket)
        if pad_s is not None:
            sp.set("pad_ms", round(pad_s * 1e3, 3))
        if service_s is not None:
            sp.set("compute_ms", round(service_s * 1e3, 3))
        if error is not None:
            sp.set("error", error)
        sp.finish()
        req.span = None


from .envutil import env_int as _env_int, env_float as _env_float


def _env_buckets():
    v = os.environ.get("MXNET_TPU_SERVE_BUCKETS")
    if not v:
        return None
    return sorted(int(b) for b in v.split(",") if b.strip())


class ModelServer:
    """Serve single-sample requests from many threads through one
    dynamically-batched, bucket-padded forward fn.

    ``model`` may be:

    - a gluon ``(Hybrid)Block`` — served from a copy of its current
      parameter values, one CUDA graph per bucket on the card (see the
      module docstring);
    - any callable ``fn(batch) -> batch`` of numpy arrays (tests,
      custom backends).

    A ``deploy.Predictor`` artifact raises ``TypeError``: the port has
    no ``export_predictor`` / ``load_predictor`` yet (ROADMAP.md §1
    item 14).

    Requests are single samples of shape ``item_shape`` (no batch
    dim). The server owns one worker thread; dispatch is serialized by
    design — batching, not thread fan-out, is the throughput lever.
    """

    def __init__(self, model, max_batch_size=None, max_delay_ms=None,
                 buckets=None, item_shape=None, dtype=None,
                 event_log=None, name="serve", max_queue=None,
                 deadline_ms=None, breaker_threshold=None,
                 breaker_cooldown_ms=None):
        if buckets is None:
            buckets = _env_buckets()
        if max_batch_size is None:
            max_batch_size = (max(buckets) if buckets
                              else _env_int("MXNET_TPU_SERVE_MAX_BATCH", 8))
        if max_delay_ms is None:
            max_delay_ms = _env_float("MXNET_TPU_SERVE_MAX_DELAY_MS", 2.0)
        if buckets is None:
            buckets = bucket_sizes(max_batch_size)
        self._bucket_spec = BucketSpec(buckets, axis=0)
        buckets = self._bucket_spec.buckets
        if max_batch_size > max(buckets):
            raise ValueError(
                f"max_batch_size {max_batch_size} exceeds the largest "
                f"bucket {max(buckets)}")
        self.name = name
        self.max_batch_size = max_batch_size
        self.max_delay_s = max_delay_ms / 1e3
        self.buckets = buckets
        self.max_queue, self.default_deadline_ms = \
            resolve_overload_knobs(max_queue, deadline_ms)
        self._item_shape = tuple(item_shape) if item_shape else None
        self._dtype = np.dtype(dtype) if dtype else None
        self._fn = self._build_fn(model)
        self._queue = MicroBatchQueue(max_depth=self.max_queue)
        self._stats = ServingStats(server=name)
        # flight recorder BEFORE the breaker: CircuitBreaker invokes
        # on_state(CLOSED) during its own __init__
        self._flight = get_flightrecorder()
        self._breaker = CircuitBreaker(
            threshold=breaker_threshold,
            cooldown_ms=breaker_cooldown_ms,
            on_state=self._on_breaker_state)
        self._events = (EventLog(event_log) if event_log is not None
                        else EventLog.from_env())
        self._worker = None
        self._started = False
        self._abort = None      # set to an abort reason string
        self._inflight = []     # popped batch the worker owns right now
        # quiesce/resume lifecycle (fleet hot-swap drain): an admission
        # gate plus EXACT in-flight accounting — `_live` counts Futures
        # admitted but not yet resolved, maintained by done-callbacks,
        # so quiesce() can wait for true zero without touching the
        # queue (whose close() is permanent)
        self._lifecycle = threading.Condition()
        self._admitting = True  # guarded-by: _lifecycle
        self._live = 0          # guarded-by: _lifecycle
        self._drained = threading.Event()
        self._guard_watcher = None
        self._guard_stop = threading.Event()
        self._flight.register(f"serving:{name}", self)

    def _on_breaker_state(self, state):
        """Breaker transition observer: gauge + flight decision log."""
        self._stats.record_breaker_state(state)
        fl = self._flight
        if fl.enabled:
            fl.event("breaker", attrs={"server": self.name,
                                       "state": state})

    # ---------------------------------------------------------- backend --
    def _build_fn(self, model):
        """Normalize ``model`` to ``fn(np (b, *item)) -> np (b, *out)``."""
        from ..gluon.block import Block
        self._backend = None
        if isinstance(model, Block):
            self._backend = _BlockBackend(model, self.name)
            return self._backend
        if _is_predictor(model):
            raise TypeError(
                "the port cannot serve a deploy.Predictor artifact yet: "
                "export_predictor / load_predictor are not ported "
                "(ROADMAP.md §1 item 14); serve the gluon Block itself")
        if callable(model):
            return model
        raise TypeError(f"cannot serve model of type {type(model)!r}")

    # -------------------------------------------------------- lifecycle --
    def start(self):
        if self._started:
            return self
        self._started = True
        self._worker = threading.Thread(
            target=self._serve_loop, name=f"mxtpu-{self.name}-worker",
            daemon=True)
        self._worker.start()
        self._events.emit("start", name=self.name, buckets=self.buckets,
                          max_batch=self.max_batch_size,
                          max_delay_ms=self.max_delay_s * 1e3,
                          max_queue=self.max_queue)
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
        return False

    @property
    def running(self):
        return self._started and not self._queue.closed

    # ----------------------------------------------------------- warmup --
    def warmup(self):
        """Run every bucket once (on CUDA, a Block's run captures the
        bucket's graph). Returns {bucket: seconds}. After this,
        steady-state serving builds and captures nothing: every shape
        the worker can emit has its graph."""
        if self._item_shape is None or self._dtype is None:
            raise RuntimeError(
                "warmup() needs item_shape/dtype — pass them to the "
                "constructor (Block.serve(example_input=...) sets "
                "both)")
        timings = {}
        for b, shape in self._bucket_spec.warmup_shapes(self._item_shape):
            zeros = np.zeros(shape, dtype=self._dtype)
            t0 = time.monotonic()
            out = self._fn(zeros)
            np.asarray(out)
            timings[b] = time.monotonic() - t0
            self._events.emit("warmup", bucket=b, seconds=timings[b])
        return timings

    # ----------------------------------------------------------- submit --
    def _estimate_wait_s(self):
        """Expected queue wait of a request admitted NOW: batches ahead
        of it times the median observed service time. Zero until the
        service histogram has data — the estimator never rejects before
        it has evidence."""
        p50 = self._stats.service_p50_s()
        if p50 <= 0.0:
            return 0.0
        return (self._queue.depth() / float(self.max_batch_size)) * p50

    def submit(self, x, deadline_ms=None, tenant=None):
        """Enqueue one sample (shape ``item_shape``); returns a Future
        resolving to this sample's output row.

        ``deadline_ms`` is the request's END-TO-END budget (default:
        ``MXNET_TPU_SERVE_DEADLINE_MS``, where an unset/0 env var
        means unbounded; an EXPLICIT ``deadline_ms=0`` argument means
        "already expired — fail fast typed", mirroring
        ``shutdown(timeout=0)``): if it expires while the request is
        queued, the Future fails with
        :class:`DeadlineExceededError` without wasting a dispatch; if
        the estimated queue wait already exceeds it, ``submit`` sheds
        the request immediately (:class:`Overloaded`,
        ``reason="deadline_unmeetable"``). A full bounded queue sheds
        with ``reason="queue_full"``; an open circuit breaker with
        :class:`CircuitOpenError`.

        ``tenant`` (optional, any string-able key) attributes this
        request's outcome on the per-tenant series
        ``mxtpu_serving_tenant_requests_total{server,tenant,outcome}``
        — untagged requests create no tenant series."""
        x = np.asarray(x)
        if self._item_shape is None:
            self._item_shape = x.shape
        if self._dtype is None:
            self._dtype = x.dtype
        if x.shape != self._item_shape:
            raise ValueError(
                f"request shape {x.shape} != item shape "
                f"{self._item_shape} (requests are single samples; the "
                "server owns the batch dimension)")
        if not self._started:
            raise RuntimeError("server not started; call start()")
        fl = self._flight
        try:
            shed_if_breaker_open(self._breaker, self._stats,
                                 self._events)
            deadline = resolve_deadline(deadline_ms,
                                        self.default_deadline_ms,
                                        self._stats, self._events)
        except Overloaded:              # breaker_open shed
            self._stats.record_tenant(tenant, "shed")
            if fl.enabled:
                fl.event("serving.shed", tenant=tenant,
                         attrs={"server": self.name,
                                "reason": "breaker_open"})
            raise
        except DeadlineExceededError:   # budget spent at submit
            self._stats.record_tenant(tenant, "expired")
            if fl.enabled:
                fl.event("serving.shed", tenant=tenant,
                         attrs={"server": self.name,
                                "reason": "deadline_at_submit"})
            raise
        if deadline is not None:
            budget_s = deadline - time.monotonic()
            est = self._estimate_wait_s()
            if est > budget_s:
                self._stats.record_shed("deadline_unmeetable")
                self._stats.record_tenant(tenant, "shed")
                self._events.emit("shed", reason="deadline_unmeetable",
                                  est_wait_ms=round(est * 1e3, 3))
                if fl.enabled:
                    fl.event("serving.shed", tenant=tenant,
                             attrs={"server": self.name,
                                    "reason": "deadline_unmeetable",
                                    "est_wait_ms": round(est * 1e3, 3)})
                raise Overloaded(
                    f"estimated queue wait {est * 1e3:.1f}ms exceeds "
                    f"the request's {budget_s * 1e3:.1f}ms deadline "
                    "budget; shed", reason="deadline_unmeetable",
                    depth=self._queue.depth())
        req = Request(x, deadline=deadline, tenant=tenant)
        tracer = get_tracer()
        if tracer.enabled:
            # hand-off span: opened here under the CALLER's current
            # span (contextvar), finished by the worker at reply — the
            # request id + queue/pad/compute decomposition ride on it.
            # Attached before enqueue so the worker can never pop a
            # request whose span is still missing.
            req.span = tracer.begin("mxtpu.serving.request", "serving",
                                    tracer.current())
        # admission gate + live increment are ONE critical section:
        # after quiesce() observes _live == 0 with admission closed, no
        # straggler submit can slip a request past it
        with self._lifecycle:
            if not self._admitting:
                if req.span is not None:
                    req.span.set("error", "ServerClosed")
                    req.span.finish()
                    req.span = None
                if fl.enabled:
                    fl.event("serving.shed", tenant=tenant,
                             attrs={"server": self.name,
                                    "reason": "quiesced"})
                raise ServerClosed(
                    "server is quiesced; admission paused "
                    "(resume() re-opens)")
            self._live += 1
        try:
            fut = self._queue.enqueue(req)
        except ServerClosed:
            self._live_dec()
            if req.span is not None:
                req.span.set("error", "ServerClosed")
                req.span.finish()
                req.span = None
            raise
        except Overloaded as exc:
            self._live_dec()
            self._stats.record_shed("queue_full")
            self._stats.record_tenant(tenant, "shed")
            self._events.emit("shed", reason="queue_full",
                              depth=exc.depth)
            if fl.enabled:
                fl.event("serving.shed", tenant=tenant,
                         attrs={"server": self.name,
                                "reason": "queue_full",
                                "depth": exc.depth})
            if req.span is not None:
                req.span.set("error", "Overloaded")
                req.span.finish()
                req.span = None
            raise
        fut.add_done_callback(self._live_dec)
        self._stats.record_submit()
        self._stats.record_tenant(tenant, "submitted")
        self._stats.record_queue_depth(self._queue.depth())
        if fl.enabled:
            fl.event("serving.submit", req=f"srv:{req.rid}",
                     tenant=tenant,
                     attrs={"server": self.name,
                            "depth": self._queue.depth(),
                            "span_id": req.span.span_id
                            if req.span is not None else None})
        return fut

    def predict(self, x, timeout=None, deadline_ms=None, tenant=None):
        """Blocking single-sample inference through the batcher."""
        return self.submit(x, deadline_ms=deadline_ms,
                           tenant=tenant).result(timeout=timeout)

    # ------------------------------------------------------------ stats --
    def stats(self):
        """Snapshot of serving counters (see ServingStats.snapshot),
        plus the process-global compile count (kernel builds and graph
        captures)."""
        snap = self._stats.snapshot()
        snap["compiles"] = compile_count()
        snap["buckets"] = list(self.buckets)
        return snap

    def programs(self):
        """A Block backend's programs: its graphs held (one per bucket
        captured; none on the CPU), the replays and the runs (every
        dispatch, eager on the CPU), capture seconds by bucket; empty
        for a callable backend."""
        b = self._backend
        if b is None:
            return {}
        return {"buckets": list(self.buckets), "graphs": b.graphs,
                "replays": b.replays, "dispatches": b.runs,
                "capture_seconds": dict(b.capture_seconds)}

    def graph_pool_bytes(self):
        """Device bytes the bucket graphs' memory pool holds."""
        return 0 if self._backend is None \
            else self._backend.graph_pool_bytes()

    def debug_status(self):
        """Structured point-in-time server state for the flight
        recorder's statusz surface. ``_admitting``/``_live`` are read
        under ``_lifecycle`` (their guard); the in-flight batch is the
        worker's private list — a torn read can misreport a row but
        only plain host state is touched."""
        with self._lifecycle:
            admitting = self._admitting
            live = self._live
        now = time.monotonic()
        inflight = [{"rid": r.rid, "tenant": r.tenant,
                     "age_s": round(now - r.t_enqueue, 3)}
                    for r in list(self._inflight)]
        return {
            "kind": "serving", "server": self.name,
            "started": self._started, "abort": self._abort,
            "admitting": admitting, "live_futures": live,
            "queue_depth": self._queue.depth(),
            "max_queue": self.max_queue,
            "buckets": list(self.buckets),
            "max_batch": self.max_batch_size,
            "breaker_state": self._breaker.state,
            "inflight": inflight,
        }

    # ------------------------------------------------------------ drain --
    def shutdown(self, drain=True, timeout=None):
        """Stop admitting; with ``drain`` serve everything queued, else
        fail queued requests with ServerClosed. Idempotent.

        ``timeout`` bounds the drain (default: the
        ``MXNET_TPU_SERVE_DRAIN_DEADLINE_MS`` env var, unbounded when
        unset). Past the deadline the remaining queued requests are
        REJECTED with ServerClosed instead of served — every Future
        still resolves, nothing is silently dropped."""
        if not self._started:
            return
        if timeout is None:
            deadline_ms = _env_float("MXNET_TPU_SERVE_DRAIN_DEADLINE_MS",
                                     0.0)
            timeout = deadline_ms / 1e3 if deadline_ms > 0 else None
        if not drain:
            # fail queued work fast: the worker resolves the remaining
            # requests with ServerClosed instead of running the model
            self._abort = "no_drain"
        self._queue.close()
        self._events.emit("drain_begin", queued=self._queue.depth())
        if self._worker is not None:
            self._worker.join(timeout=timeout)
            if self._worker.is_alive():
                # deadline expired mid-drain: flip to abort so the
                # worker fails the remaining queue instead of running
                # the model for it, then wait for that (fast) flush
                self._abort = "drain_deadline"
                self._events.emit("drain_deadline",
                                  queued=self._queue.depth())
                self._worker.join()
        self._guard_stop.set()
        if self._backend is not None:
            self._backend.release()
        self._drained.set()
        self._events.emit("stop", **{k: v for k, v in self.stats().items()
                                     if not isinstance(v, dict)})
        self._events.close()

    close = shutdown

    # ---------------------------------------------------- quiesce --
    def _live_dec(self, _fut=None):
        """Done-callback / rollback: one admitted Future resolved."""
        with self._lifecycle:
            self._live -= 1
            self._lifecycle.notify_all()

    def quiesce(self, timeout=None):
        """Stop admitting NEW requests and wait until every already-
        admitted Future has resolved. Unlike :meth:`shutdown` this
        leaves the worker thread, queue, and compiled programs warm —
        :meth:`resume` re-opens admission with zero rebuild cost (the
        fleet hot-swap drain runs on exactly this). While quiesced,
        ``submit`` raises a typed :class:`ServerClosed`.

        Returns True once drained; False if ``timeout`` (seconds)
        expired with work still in flight (the server STAYS quiesced —
        the caller decides between resume() and shutdown())."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        with self._lifecycle:
            self._admitting = False
            while self._live > 0:
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    return False
                self._lifecycle.wait(rem if rem is not None else 0.5)
            return True

    def resume(self):
        """Re-open admission after :meth:`quiesce`. Idempotent."""
        with self._lifecycle:
            self._admitting = True

    @property
    def admitting(self):
        with self._lifecycle:
            return self._admitting

    def attach_preemption_guard(self, guard, poll_s=0.05):
        """Drain on preemption: once ``guard`` (a
        ``resilience.PreemptionGuard``) reports a SIGTERM/SIGINT, stop
        admitting, flush the queue, and resolve every in-flight Future.
        The watcher is a daemon thread polling the guard's sticky flag —
        nothing runs inside the signal handler itself (the guard's
        design rule)."""
        if self._guard_watcher is not None:
            return self

        def _watch():
            while not self._guard_stop.is_set():
                if guard.wait(poll_s):
                    self._events.emit("preempted", signum=guard.signum)
                    self.shutdown(drain=True)
                    return

        self._guard_watcher = threading.Thread(
            target=_watch, name=f"mxtpu-{self.name}-preempt-watch",
            daemon=True)
        self._guard_watcher.start()
        return self

    # ------------------------------------------------------ worker loop --
    def _dispatch(self, padded):
        """One model execution. ``faults.check`` is the chaos-harness
        hook: tests script dispatch raises / injected latency here
        (site ``serving.dispatch``) without touching the model."""
        faults.check("serving.dispatch")
        return np.asarray(self._fn(padded))

    def _run(self, batch, tracer):
        """Pad ``batch`` to its bucket and dispatch once. Returns
        ``(out, bucket, pad_s, service_s)``; dispatch exceptions
        propagate to the caller (isolation / breaker logic)."""
        n = len(batch)
        bucket = self._bucket_spec.pick(n)
        t_pad = time.monotonic()
        with tracer.span("mxtpu.serving.pad", "serving"):
            rows = np.stack([r.x for r in batch]).astype(
                self._dtype, copy=False)
            padded, _ = self._bucket_spec.pad(rows, bucket)
        pad_s = time.monotonic() - t_pad
        t0 = time.monotonic()
        # one span, both sinks (tracer ring + profiler range)
        with tracer.span("mxtpu.serving.dispatch", "serving") as dsp:
            dsp.set("server", self.name)
            dsp.set("bucket", bucket)
            out = self._dispatch(padded)
        return out, bucket, pad_s, time.monotonic() - t0

    def _reply(self, batch, out, bucket, pad_s, service_s, tracer):
        """Resolve every Future in ``batch`` with its row + account."""
        fl = self._flight
        # exemplars captured BEFORE _finish_request_spans nulls spans
        exs = None
        if fl.enabled:
            exs = [(f"srv:{r.rid}",
                    r.span.span_id if r.span is not None else None)
                   for r in batch]
        with tracer.span("mxtpu.serving.reply", "serving"):
            for i, req in enumerate(batch):
                req.future.set_result(out[i])
                self._stats.record_tenant(req.tenant, "served")
                if fl.enabled:
                    fl.event("serving.served", req=f"srv:{req.rid}",
                             tenant=req.tenant,
                             attrs={"server": self.name,
                                    "bucket": bucket,
                                    "wait_ms": round(
                                        req.wait_s * 1e3, 3),
                                    "service_ms": round(
                                        service_s * 1e3, 3)})
            _finish_request_spans(batch, bucket=bucket, pad_s=pad_s,
                                  service_s=service_s)
        n = len(batch)
        self._stats.record_batch(
            n, bucket, [r.wait_s for r in batch], service_s,
            exemplars=exs)
        self._events.emit(
            "batch", n=n, bucket=bucket,
            waste=waste_fraction(n, bucket),
            service_ms=service_s * 1e3,
            max_wait_ms=max(r.wait_s for r in batch) * 1e3,
            queue_depth=self._queue.depth())

    def _isolate(self, batch, tracer):
        """Bisect-retry a failing micro-batch to isolate the poison
        row(s): halves re-dispatch independently (every sub-size pads
        to an already-warmed bucket — no captures); a failing
        singleton is the poison row and fails with ITS dispatch
        exception; everything else is served normally."""
        if len(batch) == 1:
            req = batch[0]
            try:
                out, bucket, pad_s, service_s = self._run(batch, tracer)
            except Exception as exc:
                req.future.set_exception(exc)
                _finish_request_spans(batch, error=repr(exc))
                self._stats.record_poison()
                self._stats.record_failure(1)
                self._stats.record_tenant(req.tenant, "failed")
                self._events.emit("poison", rid=req.rid,
                                  error=repr(exc))
                if self._flight.enabled:
                    self._flight.event(
                        "serving.poisoned", req=f"srv:{req.rid}",
                        tenant=req.tenant,
                        attrs={"server": self.name,
                               "error": repr(exc)})
                return
            # a successful sub-dispatch proves the BACKEND is healthy:
            # recurring poison rows must isolate forever without ever
            # accumulating into a breaker trip
            self._breaker.record_success()
            self._reply(batch, out, bucket, pad_s, service_s, tracer)
            return
        mid = len(batch) // 2
        for half in (batch[:mid], batch[mid:]):
            try:
                out, bucket, pad_s, service_s = self._run(half, tracer)
            except Exception:
                self._isolate(half, tracer)
            else:
                self._breaker.record_success()
                self._reply(half, out, bucket, pad_s, service_s, tracer)

    def _fail_remaining(self, exc):
        """Worker-death cleanup: the loop is about to die with ``exc``
        (e.g. an injected crash). Close admission and resolve EVERY
        still-pending Future — the popped in-flight batch and the whole
        queued backlog — with a typed error, so no caller ever hangs on
        a dead worker."""
        self._abort = self._abort or "worker_died"
        self._queue.close()
        stranded = [r for r in self._inflight if not r.future.done()]
        self._inflight = []
        stranded += self._queue.drain()
        if not stranded:
            return
        err = ServerClosed(f"serving worker died: {exc!r}")
        err.__cause__ = exc
        for req in stranded:
            req.future.set_exception(err)
            self._stats.record_tenant(req.tenant, "failed")
        _finish_request_spans(stranded, error="worker_died")
        self._stats.record_failure(len(stranded))
        self._events.emit("worker_died", n=len(stranded),
                          error=repr(exc))

    def _serve_loop(self):
        try:
            self._serve_loop_inner()
        except BaseException as exc:
            # InjectedCrash (chaos harness) or any unexpected loop bug:
            # black-box dump FIRST (captures the dying queue/in-flight
            # state), then never strand a Future behind a dead worker
            self._flight.crash_dump(exc, server=self.name)
            self._fail_remaining(exc)
            raise

    def _serve_loop_inner(self):
        tracer = get_tracer()
        while True:
            batch = self._queue.get_batch(self.max_batch_size,
                                          self.max_delay_s)
            if not batch:
                return  # closed and empty
            self._inflight = batch
            # chaos-harness point: crash_at_point("serving.worker")
            # simulates the worker dying mid-batch (InjectedCrash is a
            # BaseException — only _fail_remaining may see it)
            faults.point("serving.worker")
            if self._abort:
                # tell the caller WHY its request was not served: a
                # deadline-bounded drain that ran out of time is not
                # the same as a no-drain shutdown
                exc = ServerClosed(
                    "server drain deadline expired; request not served"
                    if self._abort == "drain_deadline"
                    else "server shut down without drain")
                for req in batch:
                    req.future.set_exception(exc)
                    self._stats.record_tenant(req.tenant, "failed")
                _finish_request_spans(batch, error=self._abort)
                self._stats.record_failure(len(batch))
                self._inflight = []
                continue
            self._stats.record_queue_depth(self._queue.depth())
            # deadline gate: fail requests that died in the queue
            # BEFORE spending any dispatch on them
            now = time.monotonic()
            dead = [r for r in batch if r.expired(now)]
            if dead:
                for req in dead:
                    req.future.set_exception(DeadlineExceededError(
                        f"request {req.rid} deadline expired after "
                        f"{(now - req.t_enqueue) * 1e3:.1f}ms in queue",
                        seq_id=req.rid))
                    self._stats.record_tenant(req.tenant, "expired")
                _finish_request_spans(dead, error="deadline_expired")
                self._stats.record_deadline_expired(len(dead))
                self._stats.record_failure(len(dead))
                self._events.emit("deadline_expired", n=len(dead),
                                  at="queue")
                if self._flight.enabled:
                    for req in dead:
                        self._flight.event(
                            "serving.expired", req=f"srv:{req.rid}",
                            tenant=req.tenant,
                            attrs={"server": self.name, "at": "queue"})
                batch = [r for r in batch if not r.expired(now)]
                if not batch:
                    self._inflight = []
                    continue
                self._inflight = batch
            # breaker gate: while open, reject queued work typed
            # instead of burning dispatches that will fail anyway
            if not self._breaker.allow_dispatch():
                err = CircuitOpenError(
                    "circuit breaker open; request rejected without "
                    "dispatch", retry_after_s=self._breaker.retry_after_s())
                for req in batch:
                    req.future.set_exception(err)
                    self._stats.record_tenant(req.tenant, "failed")
                _finish_request_spans(batch, error="breaker_open")
                self._stats.record_failure(len(batch))
                self._events.emit("breaker_reject", n=len(batch))
                if self._flight.enabled:
                    self._flight.event(
                        "serving.breaker_reject",
                        attrs={"server": self.name, "n": len(batch)})
                self._inflight = []
                continue
            with tracer.span("mxtpu.serving.batch", "serving") as bsp:
                bsp.set("server", self.name)
                bsp.set("n", len(batch))
                try:
                    out, bucket, pad_s, service_s = self._run(batch,
                                                              tracer)
                except Exception as exc:    # resolve, never hang callers
                    if self._breaker.record_failure():
                        self._events.emit(
                            "breaker_open",
                            retry_after_s=round(
                                self._breaker.retry_after_s(), 4))
                    self._events.emit("batch_error", n=len(batch),
                                      error=repr(exc))
                    with tracer.span("mxtpu.serving.isolate",
                                     "serving") as isp:
                        isp.set("n", len(batch))
                        self._isolate(batch, tracer)
                else:
                    self._breaker.record_success()
                    bsp.set("bucket", bucket)
                    self._reply(batch, out, bucket, pad_s, service_s,
                                tracer)
            self._inflight = []

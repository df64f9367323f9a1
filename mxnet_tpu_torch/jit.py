"""Whole-step compilation of the port: one CUDA-graph replay a training
step (mirrors ``mxnet_tpu/jit.py``).

The eager training loop pays the host three times a step: the recorded
forward, the backward and the optimizer's update, one PyTorch dispatch
(and one kernel launch) per operation. The reference removes that cost
with one donated XLA program a step; the port's counterpart is one CUDA
graph a step. :class:`CompiledTrainStep` (``Trainer.compile_step``):

- runs the user's ``loss_fn`` (ordinary Python calling gluon blocks)
  into one graph per signature (batch bucket, the inputs' structure,
  shapes and dtypes, the recorded update program), together with the
  backward (``torch.autograd.grad`` of the loss sum, the eager gradient
  seed of ones) and the fused update (one launch of the multi-tensor
  update kernel per (op, dtype) group, ``optimizer.fused``);
- records the update's host bookkeeping every call (update counts,
  Adam's bias correction, lr/wd multipliers, the loss scaler's rescale),
  writes its scalar rows, the real-row count and the loss scale into the
  program's persistent device buffer with one copy from pinned memory,
  and replays: lr schedules, loss scales and batch tails never
  recapture;
- updates the weights and optimizer states in place, where the eager
  path does (``donate`` is accepted and changes nothing).

The first call of a signature is its warm run, eager on a side stream:
the step's real work, whose results it returns (it also builds every
kernel the step launches). The capture follows (it executes nothing);
later calls copy the batch into the graph's static inputs and replay.
Parameters the loss reads and does not train (frozen weights, BatchNorm
statistics) are read by address, so an in-place change (``set_data``)
is seen by the next replay; running statistics update in place inside
the graph. A parameter that moves (``cast``, ``reset_ctx``, a new
tensor) changes the step's layout, and its graphs are dropped.

Batch-tail bucketing: a graph replays one shape, so a ragged last batch
is zero-padded to a bucket (``MXNET_TPU_STEP_BUCKETS``, as the
reference); a mask built on the device from the real-row count zeroes
the padded rows' loss, and ``rescale_grad`` divides by the real count,
a scalar of the step's row: nothing recaptures. (BatchNorm in training
mode sees the padded rows, as in the reference.)

Float16 loss scaling: the skip decision is the host's, so an engaged
``LossScaler`` makes two graphs, the forward and backward with the
finiteness flag, then the update, replayed only when the flag says
finite (the reference's "one scalar fetch"). bfloat16 is one graph.

``remat="full"`` checkpoints the loss (``torch.utils.checkpoint``,
non-reentrant, default generators' states preserved: draws then come
from torch's default generator of the device); ``"dots"`` saves the
outputs of matrix products and convolutions and recomputes the rest. A
recomputed forward writes no running statistics (``set_data`` is
suppressed), as the reference's functional recompute writes none.

Guarded fallback, with the reference's labels, counted on
``mxtpu_train_step_fallback_total{reason}`` and kept in ``last_reason``:
``env_disabled`` (``MXNET_TPU_COMPILED_STEP=0``), ``kvstore``,
``optimizer`` (outside ``optimizer.fused``'s set), ``grad_req_add``,
``sparse_grad``, and the sticky ``trace_failed`` (the warm run raised,
e.g. a host read of a device value inside ``loss_fn``:
``NDArray.asnumpy``/``asscalar``/``item`` raise :class:`HostSyncError`
inside a step on either device, so the CPU names the failure the card's
capture would), ``unrecordable`` and ``exec_failed``. A fallback runs
the eager ``record()/backward()/step()`` path. A failed capture is not
a fallback: it raises :class:`~mxnet_tpu_torch.kernels.CaptureError`.
``mesh=`` and ``param_spec=`` (the reference's SPMD mode) are not ported
(ROADMAP.md §1 item 9).

On the CPU there are no graphs: each call runs the same step function
eagerly, with the same keys, bucketing, masks and fallbacks.
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
import warnings

import numpy as np

from . import _rng

__all__ = ["CompiledTrainStep", "HostSyncError", "in_compiled_step",
           "check_host_read", "step_buckets_config", "pick_train_bucket",
           "pad_rows"]

# fallback reasons that are deterministic for this trainer and loss_fn:
# retrying them every step would re-pay a failed warm run
_STICKY_REASONS = ("trace_failed", "unrecordable", "exec_failed")

# the ops whose outputs remat="dots" saves (matrix products and
# convolutions, as jax.checkpoint_policies.dots_saveable)
_DOT_OPS = ("mm", "addmm", "bmm", "baddbmm", "convolution",
            "_convolution", "cudnn_convolution")

_STEP = threading.local()


class HostSyncError(RuntimeError):
    """A host read of a device value inside a compiled step's
    ``loss_fn``: a graph cannot carry it."""


def in_compiled_step():
    """True while this thread runs a compiled step's ``loss_fn``."""
    return getattr(_STEP, "active", False)


def check_host_read(what):
    """Raise :class:`HostSyncError` inside a compiled step (called by
    ``NDArray``'s host reads)."""
    if getattr(_STEP, "active", False):
        raise HostSyncError(
            f"{what} reads a device value on the host inside a compiled "
            "training step; a CUDA graph cannot carry a host sync")


class _Fallback(Exception):
    """The step cannot take the compiled path; carries the reason."""

    def __init__(self, reason):
        super().__init__(reason)
        self.reason = reason


def step_buckets_config(override=None):
    """Resolve the training bucket policy: ``None`` = bucketing off
    (exact shapes; ragged tails recapture), ``"auto"`` = powers of two
    up to the largest batch seen, or an explicit sorted list of sizes.
    ``override`` (the ``buckets=`` argument) wins over the
    ``MXNET_TPU_STEP_BUCKETS`` env: False/0 = off, a list = explicit."""
    if override is not None:
        if override is False or override == 0:
            return None
        if override is True or override == "auto":
            return "auto"
        return sorted(int(b) for b in override)
    v = os.environ.get("MXNET_TPU_STEP_BUCKETS", "1").strip().lower()
    if v in ("0", "off", "false", "none"):
        return None
    if v in ("1", "auto", "on", ""):
        return "auto"
    return sorted(int(t) for t in v.split(","))


def pick_train_bucket(n, buckets, max_batch):
    """Bucket for a batch of ``n`` rows under a policy resolved by
    :func:`step_buckets_config`."""
    from .serving.bucketing import bucket_sizes, pick_bucket
    if buckets is None:
        return n
    if buckets == "auto":
        return pick_bucket(n, bucket_sizes(max_batch))
    return pick_bucket(n, buckets) if n <= buckets[-1] else n


def pad_rows(v, bucket):
    """Zero-pad ``v`` (a numpy array, a tensor or an NDArray, batch on
    axis 0) up to ``bucket`` rows; returns ``v`` itself when already
    full. Host arrays pad through the serving bucketer, tensors with one
    concatenate."""
    import torch
    from .ndarray.ndarray import NDArray
    from .serving.bucketing import pad_batch
    arr = v._data if isinstance(v, NDArray) else v
    n = arr.shape[0]
    if n == bucket:
        return v
    if isinstance(arr, np.ndarray):
        return pad_batch(arr, bucket)
    pad = torch.zeros((bucket - n,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                      device=arr.device)
    out = torch.cat([arr, pad], dim=0)
    return NDArray(out) if isinstance(v, NDArray) else out


def _tracer():
    from .observability.tracing import get_tracer
    return get_tracer()


def _metrics():
    from .observability import get_registry
    reg = get_registry()
    return {
        "dispatch": reg.counter(
            "mxtpu_train_step_dispatch_total",
            "Compiled whole-step launches (steady state: exactly 1 per "
            "training step; one CUDA-graph replay on the card)."),
        "compiled": reg.counter(
            "mxtpu_train_step_compiled_total",
            "Training steps executed as one compiled forward+backward+"
            "update program."),
        "fallback": reg.counter(
            "mxtpu_train_step_fallback_total",
            "Training steps that fell back to the eager record/backward "
            "path, by reason.", ("reason",)),
        "bucket_compiles": reg.counter(
            "mxtpu_train_step_bucket_compiles_total",
            "Whole-step program builds (CUDA-graph captures on the card), "
            "by batch bucket (flat after warmup).", ("bucket",)),
        "padded_rows": reg.counter(
            "mxtpu_train_step_padded_rows_total",
            "Zero rows added to ragged batch tails to hit a captured "
            "bucket."),
    }


class _Entry:
    """One compiled signature: its static inputs, its program's launch
    tables and row buffer, and on the card its graph(s) and what they
    hold (outputs, gradients, the finiteness flag)."""

    __slots__ = ("static_in", "prog", "graph", "update_graph", "outs",
                 "grads", "found", "layout_params", "layout", "meta", "gen",
                 "ctl")

    def __init__(self):
        self.graph = self.update_graph = None
        self.outs = self.grads = self.found = None
        self.gen = None


class CompiledTrainStep:
    """One CUDA graph per (bucket, input structure, shapes and dtypes,
    recorded update program) covering forward + loss + backward +
    optimizer update. Build via ``gluon.Trainer.compile_step(loss_fn)``.

    ``loss_fn(*batch)`` is ordinary Python calling the net; it returns
    the per-sample loss (batch on axis 0, or a scalar), or a tuple whose
    FIRST element is the loss and whose others (predictions ...) ride
    along. Calling the step returns what ``loss_fn`` returned, padded
    rows sliced off, as copies.

    Semantics mirror ``loss.backward(); trainer.step(batch_rows)``: the
    gradient is of the loss SUM (the seed of ones) and ``rescale_grad``
    divides by the real row count. ``param.grad()`` buffers are NOT
    written (readers of raw gradients belong on the eager path,
    ``MXNET_TPU_COMPILED_STEP=0``). ``cache_size()`` counts the graphs
    (on the CPU: the signatures run), ``capture_seconds`` the seconds
    each bucket's warm run and capture took, ``replays`` the graph
    replays and ``graph_pool_bytes()`` the graphs' memory pool."""

    # consecutive execution failures tolerated before the compiled path
    # is disabled for this step object
    MAX_EXEC_FAILURES = 3

    def __init__(self, trainer, loss_fn, buckets=None, donate=True,
                 remat=None, mesh=None, param_spec=None):
        if remat not in (None, "", "full", "dots"):
            raise ValueError(
                f"remat must be None, 'full' or 'dots', got {remat!r}")
        if mesh is not None or param_spec is not None:
            raise NotImplementedError(
                "compile_step(mesh=, param_spec=): the SPMD mesh step is "
                "not ported yet (ROADMAP.md §1 item 9)")
        self._trainer = trainer
        self._loss_fn = loss_fn
        self._donate = donate
        self._remat = remat or None
        self._buckets = step_buckets_config(buckets)
        self._max_batch = 0
        registry = getattr(trainer, "_compiled_steps", None)
        if registry is not None:
            registry.add(self)
        restored = getattr(trainer, "_restored_step_state", None) or {}
        self.seed_bucket_state(restored.get("max_batch", 0))
        self._cache = {}      # signature key -> _Entry
        self._disabled = None
        self._exec_failures = 0
        self._obs = None
        self._lock = threading.Lock()
        self._stream = None
        self._pool = None
        self._stand_ins = {}
        self.last_reason = None
        self.capture_seconds = {}
        self.replays = 0
        self.last_cost_analysis = None

    # ------------------------------------------------------ eligibility --
    def _why_ineligible(self):
        """None when this call can take the compiled path, else the
        fallback-reason label."""
        if os.environ.get("MXNET_TPU_COMPILED_STEP", "1") == "0":
            return "env_disabled"
        if self._disabled is not None:
            return self._disabled
        tr = self._trainer
        from .optimizer.fused import fusable
        if getattr(tr, "_kvstore", None) is not None:
            return "kvstore"
        if not fusable(tr._optimizer):
            return "optimizer"
        for p in tr._params:
            if p.grad_req == "add":
                return "grad_req_add"
            if p.grad_req != "null" and (p.stype == "row_sparse"
                                         or p.grad_stype == "row_sparse"):
                return "sparse_grad"
        return None

    def _obs_metrics(self):
        if self._obs is None:
            self._obs = _metrics()
        return self._obs

    # -------------------------------------------------------- bucketing --
    def seed_bucket_state(self, max_batch):
        """Adopt bucket warmth from a restored checkpoint (monotonic)."""
        self._max_batch = max(self._max_batch, int(max_batch or 0))

    def _pick_bucket(self, n):
        if self._buckets == "auto":
            self._max_batch = max(self._max_batch, n)
        return pick_train_bucket(n, self._buckets, self._max_batch)

    # ------------------------------------------------------------- call --
    def __call__(self, *args):
        tr = self._trainer
        if not tr._kv_initialized:
            tr._init_kvstore()       # a store falls back with "kvstore"
        obs = self._obs_metrics()
        t0 = time.monotonic()
        with _tracer().span("mxtpu.train_step", "step", None, None,
                            tr._step_count):
            reason = self._why_ineligible()
            if reason is not None:
                return self._eager_step(args, reason)
            try:
                return self._compiled_step(args, obs, t0)
            except _Fallback as e:
                if e.reason == "scalar_loss_bucketed":
                    # a pre-reduced loss cannot be pad-corrected: drop
                    # the bucketing (exact shapes still compile) and
                    # retry once
                    self._buckets = None
                    try:
                        return self._compiled_step(args, obs, t0)
                    except _Fallback as e2:
                        e = e2
                if e.reason in _STICKY_REASONS:
                    self._disabled = e.reason
                return self._eager_step(args, e.reason)

    # ---------------------------------------------------- the fast path --
    def _compiled_step(self, args, obs, t0):
        from . import autograd
        from .ops import invoke as _invoke
        from .optimizer import fused as _fused

        tr = self._trainer
        opt = tr._optimizer
        scaler = getattr(tr, "_amp_loss_scaler", None)
        engaged = scaler is not None and scaler.loss_scale != 1.0

        import torch
        from .gluon.block import _flatten
        leaves, fmt = _flatten(args)
        flags = [isinstance(v, torch.Tensor) for v in leaves]
        arrays = [v for v, f in zip(leaves, flags) if f]
        opaque = tuple(v for v, f in zip(leaves, flags) if not f)
        if not arrays or arrays[0].ndim == 0:
            raise _Fallback("no_batch_axis")
        n = int(arrays[0].shape[0])

        # deferred parameter shapes resolve through one eager predict
        # pass (no running-statistics writes)
        if any(p._data is None for p in tr._params):
            with autograd.pause(train_mode=False):
                self._loss_fn(*args)

        work = [(i, p) for i, p in enumerate(tr._params)
                if p.grad_req != "null" and p._data is not None]
        if not work:
            raise _Fallback("no_trainable")
        bucket = self._pick_bucket(n)
        device = work[0][1]._data.device

        # ---- the host record pass: counts advance as in the eager loop;
        # a fallback from here on must roll them back
        scale = tr._scale / (scaler.loss_scale if engaged else 1.0)
        opt.rescale_grad = scale / n
        fused = tr._fused_updater()
        r = fused.record(None, grads=self._stand_ins_for(work), work=work)
        if r is False:
            raise _Fallback(fused.last_fallback_reason)
        rec = r.rec
        amp = _invoke._AMP
        key = (fmt, opaque, bucket, engaged, self._buckets is not None,
               self._remat, type(opt), tuple(rec.program),
               (amp["active"], amp["dtype"] if amp["active"] else None),
               tuple((tuple(a.shape[1:]) if a.shape[:1] == (n,)
                      else ("F",) + tuple(a.shape), a.dtype, a.device)
                     for a in arrays),
               tuple((tuple(w.shape), w.dtype) for w in r.weights),
               tuple((tuple(s.shape), s.dtype) for s in r.leaves))
        try:
            hash(key)
        except TypeError:
            _fused.rollback_counts(opt, work)
            raise _Fallback("unhashable_signature") from None

        entry = self._cache.get(key)
        if entry is not None and device.type == "cuda" and \
                self._layout(entry, r) != entry.layout:
            # a parameter the graphs read moved: they replay on addresses
            self.release()
            entry = None
        ls = float(scaler.loss_scale) if engaged else 1.0
        pos = _rng.reserve_draw()            # one draw position a call
        overflow = False
        if entry is None:
            with self._lock:
                try:
                    with _tracer().span("mxtpu.train_step.compile",
                                        "step") as sp:
                        sp.set("bucket", bucket)
                        entry, outs, overflow = self._build(
                            r, arrays, opaque, fmt, flags, n, bucket,
                            engaged, ls, device, pos)
                except _Fallback:
                    _fused.rollback_counts(opt, work)
                    raise
                self._cache[key] = entry
                obs["bucket_compiles"].labels(bucket=str(bucket)).inc()
        else:
            try:
                with _tracer().span("mxtpu.train_step.dispatch", "step"):
                    outs, overflow = self._run(entry, r, arrays, n, bucket,
                                               engaged, ls, device, pos)
            except _Fallback:
                _fused.rollback_counts(opt, work)
                raise
            except Exception as exc:
                warnings.warn(
                    f"compiled train step failed ({type(exc).__name__}: "
                    f"{exc}); falling back to the eager record/backward "
                    "path", stacklevel=4)
                self._exec_failures += 1
                _fused.rollback_counts(opt, work)
                raise _Fallback(
                    "exec_failed" if self._exec_failures >=
                    self.MAX_EXEC_FAILURES else "exec_retry") from None
        self._exec_failures = 0

        if overflow:
            # the update did not run: mirror the eager amp_step skip (no
            # count advance, no step tick, the scale halves)
            _fused.rollback_counts(opt, work)
            scaler.update_scale(overflow=True)
            warnings.warn(
                f"AMP: gradient overflow, skipping update and reducing "
                f"loss scale to {scaler.loss_scale}", stacklevel=3)
        else:
            if engaged:
                scaler.update_scale(overflow=False)
            tr._step_count += 1
        obs["dispatch"].inc()
        obs["compiled"].inc()
        if bucket != n:
            obs["padded_rows"].inc(bucket - n)
        if not overflow:
            # the trainer's series, written on the host after the replay
            # (an overflow skip records nothing, as the eager amp step)
            tobs = tr._obs_metrics()
            tobs["secs"].observe(time.monotonic() - t0)
            tobs["steps"].inc()
            tobs["examples"].inc(n)
            from .resilience import async_writer as _aw
            from .resilience import faults
            _aw.note_step_overlap()
            faults.on_step(tr._step_count)
        self.last_reason = None
        return self._package(entry.meta, outs, n, bucket)

    def _stand_ins_for(self, work):
        """Per trainable parameter a tensor object standing in for its
        gradient in the record pass (the recorder keys roles by object;
        the values are never read), kept while the parameter's data is."""
        out = []
        for _, p in work:
            held = self._stand_ins.get(p)
            if held is None or held[0] is not p._data:
                held = self._stand_ins[p] = (p._data, p._data.detach())
            out.append(held[1])
        return out

    # ------------------------------------------------------ the program --
    @staticmethod
    def _layout(entry, r):
        """The addresses the entry's graphs replay on: the trained
        weights' and states' (``r.layout``) and those of the other
        parameters the step read or wrote."""
        return r.layout + tuple(
            p._data.data_ptr() if p._data is not None else 0
            for p in entry.layout_params)

    def _scope(self, gen):
        """The scope of ``loss_fn`` inside a step: the in-step flag (host
        reads raise), the step's generator for ``_rng`` draws, and
        hybridized blocks running their eager forward."""
        @contextlib.contextmanager
        def scope():
            prev = getattr(_STEP, "active", False)
            _STEP.active = True
            old = _rng.push_trace_generator(gen)
            try:
                yield
            finally:
                _rng.pop_trace_generator(old)
                _STEP.active = prev
        return scope()

    def _step_fn(self, entry, engaged, masked, device):
        """The step as one function of the entry's static inputs:
        forward + loss head + backward (+ on the CPU, or on the card
        without loss scaling, the update). Returns (outputs, gradients,
        finiteness flag or None). ``warm``: the eager run, which writes
        this run's gradient addresses into the rows itself."""
        import torch
        from . import autograd
        from .gluon.block import _regroup
        from .gluon.parameter import _Access, track_access
        from .ndarray.ndarray import NDArray, unwrap
        meta = entry.meta
        loss_fn, remat = self._loss_fn, self._remat
        fmt, opaque, flags = meta["fmt"], meta["opaque"], meta["flags"]
        weights = meta["weights"]
        nrows = meta["nrows"]
        calls = [0]

        def run(*xs):
            # every call sets its own scopes: a checkpoint's recompute
            # runs it again, on the autograd engine's thread on the card,
            # and must not write the running statistics a second time
            calls[0] += 1
            with (track_access(_Access(suppress=True)) if calls[0] > 1
                  else contextlib.nullcontext()):
                return forward(*xs)

        def forward(*xs):
            arrays, rest = iter(xs), iter(opaque)
            leaves = [next(arrays) if f else next(rest) for f in flags]
            with self._scope(entry.gen), autograd.record(
                    train_mode=True):
                out = loss_fn(*_regroup(leaves, fmt))
                single = not isinstance(out, tuple)
                outs = (out,) if single else tuple(out)
                lv = unwrap(outs[0])
                if not isinstance(lv, torch.Tensor):
                    lv = torch.as_tensor(lv, device=device)
                meta["single"] = single
                meta["wrapped"] = [isinstance(o, NDArray) for o in outs]
                if lv.ndim == 0:
                    if masked:
                        raise _Fallback("scalar_loss_bucketed")
                    head = lv
                elif masked:
                    ctl = entry.ctl
                    mask = (meta["rows_idx"] < ctl[0]).to(lv.dtype)
                    head = (lv * mask.reshape(
                        mask.shape + (1,) * (lv.ndim - 1))).sum()
                else:
                    head = lv.sum()
                if engaged:
                    head = head * entry.ctl[1].to(head.dtype)
            return (head, lv) + tuple(unwrap(o) for o in outs[1:])

        def step(warm):
            calls[0] = 0
            xs = entry.static_in
            if remat == "full":
                from torch.utils.checkpoint import checkpoint
                res = checkpoint(run, *xs, use_reentrant=False,
                                 preserve_rng_state=True)
            elif remat == "dots":
                from torch.utils.checkpoint import (
                    checkpoint, create_selective_checkpoint_contexts)
                res = checkpoint(run, *xs, use_reentrant=False,
                                 context_fn=functools.partial(
                                     create_selective_checkpoint_contexts,
                                     _dots_policy))
            else:
                res = run(*xs)
            head, lv, extras = res[0], res[1], res[2:]
            got = torch.autograd.grad(head, weights, allow_unused=True)
            grads = [torch.zeros_like(w) if g is None else g.contiguous()
                     for g, w in zip(got, weights)]
            found = None
            if engaged:
                found = torch.zeros(1, device=device)
                torch._amp_foreach_non_finite_check_and_unscale_(
                    grads, found, torch.ones(1, device=device))
            prog = entry.prog
            if device.type == "cpu":
                if found is None or not bool(found.item()):
                    prog.apply_twin(_bufs(meta, grads), meta["params"])
            else:
                if warm:
                    self._write_rows(entry, grads, nrows)
                if not engaged:
                    prog.launch()
            return (lv.detach(),) + tuple(
                e.detach() if isinstance(e, torch.Tensor) else e
                for e in extras), grads, found
        return step

    def _write_rows(self, entry, grads, nrows):
        """This step's scalar rows for ``grads`` and the control row
        (real-row count, loss scale), in one copy."""
        meta = entry.meta
        rows = entry.prog.scalar_rows(meta["params"], grads)
        entry.prog.rows.write(rows, meta["ctl_host"])

    def _build(self, r, arrays, opaque, fmt, flags, n, bucket, engaged, ls,
               device, pos):
        """The first call of a signature: its static inputs, its update
        program, the warm run (this call's real step) and, on the card,
        the capture. Returns (entry, this call's outputs, overflow)."""
        import torch
        from . import kernels
        from .gluon.parameter import track_access
        from .optimizer import fused as _fused
        entry = _Entry()
        masked = self._buckets is not None
        entry.static_in = [self._stage(a, n, bucket, device)
                           for a in arrays]
        ctl_host = np.zeros(16, np.float32)
        with np.errstate(over="ignore"):   # a scale past f32's range: inf
            ctl_host[0], ctl_host[1] = n, ls
        entry.meta = meta = dict(
            fmt=fmt, opaque=opaque, flags=flags, weights=r.weights,
            leaves=r.leaves, roles=r.prog.roles, params=r.rec.params,
            nrows=sum(len(e) for _, e in r.prog.groups), ctl_host=ctl_host,
            rows_idx=torch.arange(bucket, device=device,
                                  dtype=torch.float32))
        prog = entry.prog = _fused._Program(r.rec.program, r.weights)
        cuda = device.type == "cuda"
        if cuda:
            # the tables take each weight as its gradient's stand-in: the
            # gradients' addresses ride each step's rows
            bufs = dict(r.bufs)
            for k, w in enumerate(r.weights):
                bufs[("g", k)] = w
            self._trainer._fused.tables_built += prog.bind(
                bufs, r.layout, extra_rows=1)
            entry.ctl = prog.rows.dev[meta["nrows"] * 16:
                                      meta["nrows"] * 16 + 2]
            entry.gen = self._generator(device, pos)
        else:
            entry.ctl = torch.tensor([float(n), ls], dtype=torch.float32)
            entry.gen = self._generator(device, pos)
        step = self._step_fn(entry, engaged, masked, device)
        t0 = time.monotonic()
        access = None
        try:
            with track_access() as access:
                if cuda:
                    if self._stream is None:
                        self._stream = torch.cuda.Stream(device)
                        self._pool = torch.cuda.graph_pool_handle()
                    # the warm run's forward reads the control row
                    prog.rows.write(np.zeros((meta["nrows"], 16),
                                             np.float32), ctl_host)
                    outs, grads, found = kernels.warm(
                        lambda: self._counted(step, True), self._stream,
                        "a compiled training step")
                else:
                    outs, grads, found = self._counted(step, False)
        except Exception as exc:
            if access is not None:
                access.restore()
            if isinstance(exc, _Fallback):
                raise
            cause = exc.__cause__ if isinstance(
                exc, kernels.CaptureError) and exc.__cause__ else exc
            if isinstance(cause, _Fallback):
                raise cause from None
            warnings.warn(
                "whole-step trace failed "
                f"({type(cause).__name__}: {cause}); training continues "
                "on the eager path", stacklevel=5)
            raise _Fallback("trace_failed") from None
        if cuda:
            # made on the side stream, read on the current one: the
            # allocator must not hand them out before that read is done
            current = torch.cuda.current_stream(device)
            for t in (*grads, *outs):
                if isinstance(t, torch.Tensor):
                    t.record_stream(current)
        overflow = found is not None and bool(found.item())
        # the graph depends on the addresses of what it reads
        trained = {p for _, p in r.work}
        entry.layout_params = [p for p in set(access.reads) | set(access.saved)
                               if p not in trained]
        entry.layout = self._layout(entry, r)
        if cuda:
            if engaged and not overflow:
                prog.launch()                 # this call's update
            held = {}

            def capture_step():
                held["res"] = step(False)
            what = f"a compiled training step (bucket {bucket})"
            entry.graph = kernels.capture(
                capture_step, self._stream, self._pool, what=what,
                warmed=True, generators=() if self._remat else (entry.gen,))
            entry.outs, entry.grads, entry.found = held["res"]
            if engaged and not overflow:
                entry.update_graph = kernels.capture(
                    prog.launch, self._stream, self._pool,
                    what=f"{what}'s update", warmed=True)
            self.capture_seconds[bucket] = time.monotonic() - t0
        return entry, outs, overflow

    def _run(self, entry, r, arrays, n, bucket, engaged, ls, device, pos):
        """A later call of a signature: copy the batch in, write the
        rows, replay (on the CPU: run the step function again)."""
        import torch
        from . import kernels
        meta = entry.meta
        meta["params"] = r.rec.params
        with np.errstate(over="ignore"):   # a scale past f32's range: inf
            meta["ctl_host"][0], meta["ctl_host"][1] = n, ls
        if entry.graph is None:             # the CPU
            meta["weights"], meta["leaves"] = r.weights, r.leaves
            entry.static_in = [self._stage(a, n, bucket, device)
                               for a in arrays]
            entry.ctl = torch.tensor([float(n), ls], dtype=torch.float32)
            entry.gen = self._generator(device, pos)
            step = self._step_fn(entry, engaged, self._buckets is not None,
                                 device)
            outs, _, found = step(False)
            return outs, found is not None and bool(found.item())
        with torch.no_grad():
            for s, a in zip(entry.static_in, arrays):
                if s.shape[:1] == (bucket,) and a.shape[:1] == (n,):
                    s[:n].copy_(a)
                    if n < bucket:
                        s[n:].zero_()
                else:
                    s.copy_(a)
        self._write_rows(entry, entry.grads, meta["nrows"])
        entry.graph.replay()
        self.replays += 1
        overflow = False
        if engaged:
            overflow = bool(entry.found.item())   # the one host sync
            if not overflow:
                if entry.update_graph is None:
                    entry.prog.launch()
                    entry.update_graph = kernels.capture(
                        entry.prog.launch, self._stream, self._pool,
                        what=f"a compiled training step's update (bucket "
                             f"{bucket})", warmed=True)
                else:
                    entry.update_graph.replay()
                    self.replays += 1
        outs = tuple(o.clone() if isinstance(o, torch.Tensor) else o
                     for o in entry.outs)
        return outs, overflow

    def _generator(self, device, pos):
        """The step's generator: draw ``pos``'s (on the card, registered
        with the graph and advanced by each replay; on the CPU, one a
        call), or torch's default one of the device under remat, whose
        state the checkpoint preserves for its recompute."""
        import torch
        if not self._remat:
            return _rng.generator_for(_rng.get_state()["seed"], pos, device)
        if device.type == "cpu":
            return torch.default_generator
        return torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()]

    @staticmethod
    def _stage(a, n, bucket, device):
        """A static input on ``device`` (the trained parameters'): ``a``
        zero-padded to ``bucket`` rows when its leading axis is the
        batch's, else a copy."""
        import torch
        a = a.detach().to(device)
        if a.shape[:1] == (n,) and bucket != n:
            return pad_rows(a, bucket).contiguous()
        return torch.empty_like(a, memory_format=torch.contiguous_format) \
            .copy_(a)

    def _package(self, meta, outs, n, bucket):
        from .ndarray.ndarray import NDArray

        def trim(v, wrapped):
            if hasattr(v, "shape") and v.shape[:1] == (bucket,) \
                    and n != bucket:
                v = v[:n].clone()
            return NDArray(v) if wrapped else v
        res = tuple(trim(v, w) for v, w in zip(outs, meta["wrapped"]))
        return res[0] if meta["single"] else res

    # ------------------------------------------------------- eager path --
    def _eager_step(self, args, reason):
        """The guarded fallback: the plain record/backward/step loop
        (which itself runs the fused update when it can). Counted by
        reason; semantics identical to hand-written eager training,
        including the AMP wrapper's overflow skip."""
        from . import autograd
        obs = self._obs_metrics()
        obs["fallback"].labels(reason=reason).inc()
        self.last_reason = reason
        tr = self._trainer
        scaler = getattr(tr, "_amp_loss_scaler", None)
        import torch
        from .gluon.block import _flatten
        n = 1
        for v in _flatten(args)[0]:
            if isinstance(v, torch.Tensor) and v.ndim:
                n = int(v.shape[0])
                break
        with _tracer().span("mxtpu.train_step.fallback", "step") as sp:
            sp.set("reason", reason)
            with autograd.record():
                out = self._loss_fn(*args)
                loss = out[0] if isinstance(out, tuple) else out
                head = loss * scaler.loss_scale \
                    if scaler is not None and scaler.loss_scale != 1.0 \
                    else loss
            autograd.backward(head)
            tr.step(n)
        return out

    def _counted(self, step, warm):
        """``step(warm)``, its FLOPs counted into
        :attr:`last_cost_analysis`: torch's ``FlopCounterMode`` counts the
        matrix products of the forward, the backward and the update; the
        flash attention kernels (K6, K7), opaque to it, are counted from
        their shapes (``ops.flash_attention.opaque_flops``: 4·D a
        (query, key) pair forward, 8·D backward, as PERF.md §6's bounds
        count them)."""
        from torch.utils.flop_counter import FlopCounterMode
        from .ops.flash_attention import opaque_flops
        with FlopCounterMode(display=False) as counter, \
                opaque_flops() as opaque:
            res = step(warm)
        self.last_cost_analysis = {
            "flops": float(counter.get_total_flops() + opaque["flops"])}
        return res

    # ------------------------------------------------------- introspect --
    def cache_size(self):
        """The graphs held (on the CPU: the signatures run)."""
        return sum(1 if e.graph is None else
                   1 + (e.update_graph is not None)
                   for e in self._cache.values())

    def cost_analysis(self):
        """``{"flops": ...}`` of the most recently built step, counted
        over its warm run (None before the first step), as the JAX
        package's XLA cost analysis; feeds an MFU."""
        return self.last_cost_analysis

    def graph_pool_bytes(self):
        """Device bytes the step's graph memory pool holds (0 on the CPU
        or with no graph held)."""
        if self._pool is None:
            return 0
        import torch
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def release(self):
        """Drop every graph and the pool; the next call captures again."""
        with self._lock:
            self._cache = {}
            self._stream = self._pool = None


def _bufs(meta, grads):
    """Role -> tensor for the update's twin on the CPU."""
    bufs = {}
    for k, w in enumerate(meta["weights"]):
        bufs[("w", k)] = w
        bufs[("g", k)] = grads[k]
    for j, leaf in enumerate(meta["leaves"]):
        bufs[("s", j)] = leaf
    return bufs


def _dots_policy(ctx, op, *args, **kwargs):
    """remat="dots": save what matrix products and convolutions return,
    recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    name = getattr(op, "__name__", "").split(".")[0]
    return CheckpointPolicy.MUST_SAVE if name in _DOT_OPS else \
        CheckpointPolicy.PREFER_RECOMPUTE

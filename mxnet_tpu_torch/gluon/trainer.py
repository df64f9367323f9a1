"""Gluon ``Trainer`` of the port (mirrors ``mxnet_tpu/gluon/trainer.py``),
for one device.

``step(batch_size, ignore_stale_grad=False)`` sets ``rescale_grad =
scale / batch_size`` and applies the optimizer to every parameter with a
gradient, in index order (parameters sorted by name): through
:class:`~mxnet_tpu_torch.optimizer.FusedUpdater` (one launch of the
multi-tensor update kernel per (op, dtype) group) when it may run, else
through the ``Updater`` loop, one update op per parameter. The loop
runs for ``ignore_stale_grad=True`` (as in the reference, it then updates
every parameter with a gradient), ``MXNET_TPU_FUSED_UPDATE=0`` and the
other fallbacks of ``optimizer/fused.py``; ``fused.fallbacks`` counts
them by reason.

Each step opens a ``mxtpu.trainer.step`` span and reports the
reference's training series on the registry (``_obs_metrics``):
``mxtpu_training_optimizer_steps_total``, ``..._optimizer_step_seconds``
and ``mxtpu_training_examples_total``; the update's
``mxtpu_trainer_update_dispatch_total``, ``..._fused_total`` (the fused
kernel's launches) and ``..._fallback_total{reason}``; under
``MXNET_TPU_METRICS_GRAD_NORM=1`` the gauge ``mxtpu_training_grad_norm``
(a host read of every gradient, so off by default).

The store (``kvstore=``, ``compression_params=``, ``update_on_kvstore=``,
the reference's arguments) is made at the first step, as the
reference's: on one device ``"device"``, ``"local"``, ``None``, ``""``
and ``"nullkv"`` take no store and update in place; another type name
makes ``mx.kv.create(name)`` (updating on the store when it can, unless
``update_on_kvstore=False``); a store instance is used as given, with
``update_on_kvstore`` as the caller sets it. With a store,
``allreduce_grads`` pushes each gradient and pulls the sum back (or,
updating on the store, ``step`` pulls the store's weights).
``compression_params`` is kept and not applied, as the reference's
Trainer keeps it: compression is set on a store
(``set_gradient_compression``). Parameters
are read at each step, not at construction, so a ``Dense`` whose shape
is deferred until the first forward is updated once it exists (the JAX
Trainer's ``_params_to_init``); until then it is skipped. A row-sparse
gradient (``Embedding(sparse_grad=True)``) reaches the optimizer as an
``nd.sparse.RowSparseNDArray`` through the loop (``sparse_grad``).

``compile_step(loss_fn)`` returns a :class:`mxnet_tpu_torch.jit.
CompiledTrainStep`: forward, backward and this update as one CUDA-graph
replay a step.

Checkpoints: ``save_states``/``load_states`` write and read the
optimizer's states alone (atomically); ``save_state``/``restore_state``/
``ckpt_wait`` the full training state through the checkpoint stack of
:mod:`mxnet_tpu_torch.resilience` (the reference's directory layout and
formats), for a bit-exact resume after a restart.
"""
from __future__ import annotations

import os
import pickle
import time
import weakref

import numpy as np
import torch

from .. import _rng
from .. import optimizer as opt
from ..observability.registry import get_registry
from ..observability.tracing import get_tracer
from ..resilience import async_writer as _aw
from ..resilience import checkpoint as _ckpt
from ..resilience import faults
from ..resilience.atomic import atomic_write
from .parameter import Parameter

__all__ = ["Trainer"]


class Trainer:
    """Applies an optimizer to a set of Parameters."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if hasattr(params, "items"):
            params = [params[key] for key in sorted(params.keys())]
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                f"got {type(params)}.")
        for p in params:
            if not isinstance(p, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    f"got list of {type(p)}.")
        self._params = list(params)
        self._step_count = 0
        self._ckpt_mgrs = {}   # realpath(run_dir) -> CheckpointManager
        self._compiled_steps = weakref.WeakSet()
        self._restored_step_state = None
        self._compression_params = compression_params
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
        # a parameter stored row-sparse (MXNet's flag; the storage here
        # stays dense: Parameter.row_sparse_data gathers its rows)
        self._contains_sparse_weight = any(
            p.stype != "default" for p in self._params)

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)]
        self._fused = None
        self._obs = None

    def _init_kvstore(self):
        """Make the store (at the first step, as the reference's)."""
        config = self._kvstore_params
        kv = config["kvstore"]
        if kv is None or kv in ("", "nullkv"):
            self._kvstore, self._update_on_kvstore = None, False
        elif isinstance(kv, str):
            ctxs = self._params[0].list_ctx() if self._params else []
            if kv in ("local", "device") and len(ctxs) <= 1:
                # one device: a store adds nothing, update in place
                self._kvstore, self._update_on_kvstore = None, False
            else:
                from .. import kvstore as kvs
                self._kvstore = kvs.create(kv)
                self._update_on_kvstore = (
                    config["update_on_kvstore"]
                    if config["update_on_kvstore"] is not None
                    else self._kvstore.is_capable("optimizer"))
                if self._update_on_kvstore:
                    self._kvstore.set_optimizer(self._optimizer)
        else:
            self._kvstore = kv
            self._update_on_kvstore = bool(config["update_on_kvstore"])
        if self._kvstore is not None:
            for i, param in enumerate(self._params):
                self._kvstore.init(i, param.data())
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _obs_metrics(self):
        """The training series on the registry, under the reference's
        names, help texts and labels (the compiled step reports the
        first three too)."""
        if self._obs is None:
            reg = get_registry()
            self._obs = {
                "steps": reg.counter(
                    "mxtpu_training_optimizer_steps_total",
                    "Trainer.step calls (allreduce + update)."),
                "secs": reg.histogram(
                    "mxtpu_training_optimizer_step_seconds",
                    "Time inside Trainer.step (allreduce + update)."),
                "examples": reg.counter(
                    "mxtpu_training_examples_total",
                    "Examples processed (sum of Trainer.step "
                    "batch sizes)."),
                "grad_norm": reg.gauge(
                    "mxtpu_training_grad_norm",
                    "Global L2 gradient norm of the last step "
                    "(MXNET_TPU_METRICS_GRAD_NORM=1 only; costs a "
                    "host sync)."),
                "want_grad_norm": os.environ.get(
                    "MXNET_TPU_METRICS_GRAD_NORM") == "1",
                "upd_dispatch": reg.counter(
                    "mxtpu_trainer_update_dispatch_total",
                    "Compiled optimizer-update program launches "
                    "(fused path: 1 per step regardless of parameter "
                    "count)."),
                "upd_fused": reg.counter(
                    "mxtpu_trainer_update_fused_total",
                    "Trainer.step updates applied as one fused, "
                    "buffer-donating dispatch."),
                "upd_fallback": reg.counter(
                    "mxtpu_trainer_update_fallback_total",
                    "Trainer.step updates that ran the per-param loop, "
                    "by reason.", ("reason",)),
            }
        return self._obs

    def _observe_grad_norm(self, obs):
        """The global L2 norm of the gradients, summed in float64 on the
        host (opt-in: it reads every gradient back, a device sync)."""
        total = 0.0
        for param in self._params:
            if param.grad_req == "null" or param._data is None:
                continue
            g = param.grad()
            g = getattr(g, "_data", g)      # a RowSparseNDArray densifies
            a = g.detach().to("cpu", torch.float64).numpy()
            total += float((a * a).sum())
        obs["grad_norm"].set(total ** 0.5)

    def _fused_updater(self):
        if self._fused is None:
            self._fused = opt.FusedUpdater(self._optimizer,
                                           self._updaters[0])
        return self._fused

    def compile_step(self, loss_fn, buckets=None, donate=True, remat=None,
                     mesh=None, param_spec=None):
        """The WHOLE training step — forward + loss + backward + this
        optimizer update — as one CUDA-graph replay a call on the card
        (:class:`mxnet_tpu_torch.jit.CompiledTrainStep`; on the CPU the
        same step runs eagerly).

        ``loss_fn(*batch)`` is ordinary Python calling the net; it
        returns the per-sample loss, or a tuple ``(loss, *extras)``. The
        returned step object replaces the ``record()/backward()/step()``
        triple::

            step = trainer.compile_step(lambda x, y: loss(net(x), y))
            for x, y in loader:
                l = step(x, y)           # one graph replay

        Steps that cannot compile (sparse gradients, optimizers outside
        the fused set, a host read inside ``loss_fn``,
        ``grad_req='add'``) fall back to the eager path per step, counted
        by reason on ``mxtpu_train_step_fallback_total``. ``buckets``
        pads ragged batches to a few sizes (default
        ``MXNET_TPU_STEP_BUCKETS``); ``remat`` ('full'/'dots') recomputes
        the forward in the backward for memory headroom; ``donate`` is
        accepted (the update is in place anyway). ``mesh``/
        ``param_spec`` (the reference's SPMD step) are not ported yet
        and raise ``NotImplementedError`` (ROADMAP.md §1 item 9)."""
        from ..jit import CompiledTrainStep
        return CompiledTrainStep(self, loss_fn, buckets=buckets,
                                 donate=donate, remat=remat, mesh=mesh,
                                 param_spec=param_spec)

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimizer update of every parameter, gradients rescaled by
        ``1 / batch_size`` (allreduce + update)."""
        if not self._kv_initialized:
            self._init_kvstore()
        obs = self._obs_metrics()
        t0 = time.monotonic()
        with get_tracer().span("mxtpu.trainer.step", "step", None, None,
                               self._step_count):
            self._optimizer.rescale_grad = self._scale / batch_size
            self._allreduce_grads()
            if obs["want_grad_norm"]:
                try:
                    self._observe_grad_norm(obs)
                except Exception:
                    pass
            self._update(ignore_stale_grad)
        obs["secs"].observe(time.monotonic() - t0)
        obs["steps"].inc()
        obs["examples"].inc(batch_size)
        self._step_count += 1
        _aw.note_step_overlap()
        faults.on_step(self._step_count)

    def allreduce_grads(self):
        """Sum the gradients through the store (without one, on one
        device, there is nothing to sum)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise AssertionError(
                "allreduce_grads() when parameters are updated on kvstore "
                "is not supported. Try setting `update_on_kvstore` to False "
                "when creating trainer.")
        self._allreduce_grads()

    def _allreduce_grads(self):
        if self._kvstore is None:
            return
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._data is None:
                continue
            self._kvstore.push(i, param.list_grad(), priority=-i)
            if not self._update_on_kvstore:
                self._kvstore.pull(i, param.list_grad(), priority=-i)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update of :meth:`step` without the allreduce."""
        if not self._kv_initialized:
            self._init_kvstore()
        assert not self._update_on_kvstore, \
            "update() when parameters are updated on kvstore is not " \
            "supported. Try setting `update_on_kvstore` to False when " \
            "creating trainer."
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        if self._update_on_kvstore:
            # the store's updater stepped its copies at the push
            for i, param in enumerate(self._params):
                if param.grad_req == "null" or param._data is None:
                    continue
                self._kvstore.pull(i, param.list_data(), priority=-i)
            return
        obs = self._obs_metrics()
        fused = self._fused_updater()
        reason = fused.why_ineligible(self._params, ignore_stale_grad)
        if reason is None:
            if fused.step(self._params):
                obs["upd_dispatch"].inc(fused.last_dispatches)
                obs["upd_fused"].inc(fused.last_dispatches)
                return
            reason = fused.last_fallback_reason
        fused.fallbacks[reason] += 1
        obs["upd_fallback"].labels(reason=reason).inc()
        updater = self._updaters[0]
        dispatches = 0
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._data is None:
                continue
            updater(i, param.grad(), param.data())
            dispatches += 1
        obs["upd_dispatch"].inc(dispatches)

    def save_states(self, fname):
        """Write the optimizer's states (numpy arrays, see
        ``optimizer/updater.py``) to ``fname`` through ``atomic_write``
        (temp file + fsync + rename): a crash mid-write leaves the
        previous file."""
        if not self._kv_initialized:
            self._init_kvstore()
        with atomic_write(fname) as f:
            f.write(self._updaters[0].get_states(
                dump_optimizer=bool(self._update_on_kvstore)))

    def load_states(self, fname):
        """Read states written by :meth:`save_states`; they move to
        their weights' device at the next update."""
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, "rb") as f:
            states = f.read()
        self._updaters[0].set_states(states)
        self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._fused = None  # the optimizer object may have been replaced

    # -------------------------------------------------- full-state ckpt --
    def save_state(self, run_dir, step=None, epoch=None, keep=5,
                   num_shards=None):
        """Commit the full training state to a crash-safe checkpoint
        directory (reference: ``mxnet_tpu/gluon/trainer.py save_state``):
        parameter values, optimizer slots and update counts, the AMP loss
        scaler's state, torch's CPU and CUDA generator states (dropout
        draws from them), the process RNG's ``(seed, draws)``, the step
        counter and the compiled steps' bucket warmth. With
        :meth:`restore_state`
        a run resumes bit for bit across a restart.

        ``MXNET_TPU_CKPT_SHARDED`` (or ``num_shards=``) writes the
        parallel per-shard v2 layout; ``MXNET_TPU_CKPT_ASYNC=1`` snapshots
        the state to the host here (blocking copies: the step boundary is
        consistent) and serializes it on a background writer, returning
        an :class:`~mxnet_tpu_torch.resilience.AsyncSaveHandle` instead of
        the path (:meth:`ckpt_wait` joins; a failed background write
        raises ``CheckpointWriteError`` on the next save or wait).
        Returns None on non-zero ranks of a process group."""
        # keyed by position, not name: name prefixes count up per process
        arrays = {f"param:{i}": p._data for i, p in enumerate(self._params)
                  if p._data is not None}
        # the Adam-family bias corrections count on the optimizer itself
        blob = pickle.dumps({
            "updater": self._updaters[0].get_states(dump_optimizer=False),
            "optimizer": type(self._optimizer).__name__,
            "index_update_count": dict(
                self._optimizer._index_update_count),
            "num_update": self._optimizer.num_update,
            "rng": _rng_state()})
        scaler = getattr(self, "_amp_loss_scaler", None)
        extra = {
            "trainer": "gluon",
            "step_count": self._step_count,
            "rng": _rng.get_state(),
            "scaler": scaler.state_dict() if scaler is not None else None,
            "param_names": [p.name for p in self._params],
        }
        # compiled-step bucket warmth rides along, so a resumed run pads
        # ragged tails to the same buckets (the same numerics for
        # batch-statistics nets, no cold captures on resume)
        max_batch = max((s._max_batch for s in self._compiled_steps),
                        default=0)
        if max_batch:
            extra["compiled_step"] = {"max_batch": int(max_batch)}
        mgr = _ckpt.manager_for(self._ckpt_mgrs, run_dir, keep=keep,
                                num_shards=num_shards)
        return mgr.save(arrays,
                        step=self._step_count if step is None else step,
                        epoch=epoch, extra=extra,
                        blobs={_ckpt.TRAINER_FILE: blob})

    def ckpt_wait(self):
        """Join every in-flight async checkpoint save this trainer
        started; drains all run dirs before raising the first failure.
        A no-op when async checkpointing is off."""
        first = None
        for mgr in self._ckpt_mgrs.values():
            try:
                mgr.wait()
            except BaseException as exc:   # noqa: B036 — InjectedCrash
                if first is None:
                    first = exc
        if first is not None:
            raise first

    def restore_state(self, run_dir):
        """Restore from the newest valid checkpoint under ``run_dir``
        (corrupt or partial ones are skipped); reads the reference's
        checkpoints too. The process RNG's ``(seed, draws)`` entry is
        restored (a compiled step advances it once a call, so a resumed
        run draws from where the saved one stopped). The
        ``compiled_step`` entry seeds the bucket warmth of
        this trainer's compiled steps, live or made later. Returns the
        manifest, whose
        ``step``/``extra`` tell the loop where to resume. Raises
        ``CheckpointCorruptError`` if nothing restorable exists and
        ``InternalError`` on a missing or mis-shaped parameter."""
        from .. import error
        path, manifest = _ckpt.latest_checkpoint(run_dir)
        if path is None:
            raise error.CheckpointCorruptError(
                f"'{run_dir}': no restorable checkpoint found")
        arrays = _ckpt.read_arrays(path, manifest)
        for i, p in enumerate(self._params):
            v = arrays.get(f"param:{i}")
            if v is None:
                if p._data is not None:
                    raise error.InternalError(
                        f"checkpoint '{path}' is missing parameter #{i} "
                        f"('{p.name}')")
                continue
            if p._data is not None and tuple(p.shape) != tuple(v.shape):
                raise error.InternalError(
                    f"checkpoint '{path}' parameter #{i} ('{p.name}') has "
                    f"shape {tuple(v.shape)}, trainer expects {p.shape}")
            p.set_data(v)
        blob = pickle.loads(_ckpt.read_blob(path, _ckpt.TRAINER_FILE,
                                            manifest))
        self._updaters[0].set_states(blob["updater"])
        self._updaters[0].optimizer = self._optimizer
        self._optimizer._index_update_count = {
            int(k): int(v)
            for k, v in blob.get("index_update_count", {}).items()}
        self._optimizer.num_update = int(
            blob.get("num_update", self._optimizer.num_update))
        self._fused = None   # its tables point at the replaced states
        if blob.get("rng") is not None:
            _set_rng_state(blob["rng"])
        extra = manifest.get("extra", {})
        self._step_count = int(extra.get("step_count",
                                         manifest.get("step", 0)))
        if isinstance(extra.get("rng"), dict) and "draws" in extra["rng"]:
            _rng.set_state(extra["rng"])
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None and extra.get("scaler") is not None:
            scaler.load_state_dict(extra["scaler"])
        self._restored_step_state = extra.get("compiled_step") or None
        if self._restored_step_state:
            mb = int(self._restored_step_state.get("max_batch", 0) or 0)
            for s in self._compiled_steps:
                s.seed_bucket_state(mb)
        return manifest


def _rng_state():
    """torch's CPU generator state and, once CUDA is in use, each
    card's, as uint8 numpy arrays."""
    cuda = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        cuda = [s.numpy() for s in torch.cuda.get_rng_state_all()]
    return {"cpu": torch.get_rng_state().numpy(), "cuda": cuda}


def _set_rng_state(state):
    torch.set_rng_state(torch.from_numpy(np.array(state["cpu"])))
    if state.get("cuda") is not None and torch.cuda.is_available():
        for i, s in enumerate(state["cuda"][:torch.cuda.device_count()]):
            torch.cuda.set_rng_state(torch.from_numpy(np.array(s)), i)

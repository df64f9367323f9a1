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

One device: no kvstore, so ``allreduce_grads`` has nothing to reduce
(the reference's does nothing without a kvstore on one context either).
Parameters are read at each step, not at construction, so a ``Dense``
whose shape is deferred until the first forward is updated once it
exists (the JAX Trainer's ``_params_to_init``); until then it is
skipped.
"""
from __future__ import annotations

import os

from .. import optimizer as opt
from .parameter import Parameter

__all__ = ["Trainer"]


class Trainer:
    """Applies an optimizer to a set of Parameters."""

    def __init__(self, params, optimizer, optimizer_params=None):
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
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)

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

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _fused_updater(self):
        if self._fused is None:
            self._fused = opt.FusedUpdater(self._optimizer,
                                           self._updaters[0])
        return self._fused

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimizer update of every parameter, gradients rescaled by
        ``1 / batch_size`` (allreduce + update)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Sum the gradients across devices: nothing to do on one."""

    def update(self, batch_size, ignore_stale_grad=False):
        """The update of :meth:`step` without the allreduce."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        fused = self._fused_updater()
        reason = fused.why_ineligible(self._params, ignore_stale_grad)
        if reason is None:
            if fused.step(self._params):
                return
            reason = fused.last_fallback_reason
        fused.fallbacks[reason] += 1
        updater = self._updaters[0]
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._data is None:
                continue
            updater(i, param.grad(), param.data())

    def save_states(self, fname):
        """Write the optimizer's states (numpy arrays, see
        ``optimizer/updater.py``) to ``fname``, atomically."""
        tmp = f"{fname}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(self._updaters[0].get_states(dump_optimizer=False))
        os.replace(tmp, fname)

    def load_states(self, fname):
        """Read states written by :meth:`save_states`; they move to
        their weights' device at the next update."""
        with open(fname, "rb") as f:
            states = f.read()
        self._updaters[0].set_states(states)
        self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._fused = None  # the optimizer object may have been replaced

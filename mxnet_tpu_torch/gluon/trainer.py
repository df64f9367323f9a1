"""Gluon ``Trainer`` of the port (mirrors ``mxnet_tpu/gluon/trainer.py``),
for one device: ``step(batch_size, ignore_stale_grad=False)`` sets
``rescale_grad = scale / batch_size`` and applies the optimizer to every parameter with a
gradient, in index order (parameters sorted by name). One device: no
kvstore, fused updater or fault hooks in this slice.

Parameters are read at each step, not at construction, so a ``Dense``
whose shape is deferred until the first forward is updated once it
exists (the JAX Trainer's ``_params_to_init``); until then it is
skipped.
"""
from __future__ import annotations

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
        self._states = {}

    @property
    def optimizer(self):
        return self._optimizer

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimizer update of every parameter, gradients rescaled by
        ``1 / batch_size``. ``ignore_stale_grad=True`` (skip parameters
        whose gradient no backward refreshed) is not ported yet
        (ROADMAP.md §1 item 13) and raises."""
        if ignore_stale_grad:
            raise NotImplementedError(
                "Trainer.step(ignore_stale_grad=True) is not ported yet "
                "(ROADMAP.md §1 item 13, training path)")
        optim = self._optimizer
        optim.rescale_grad = self._scale / batch_size
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._data is None:
                continue
            w = param.data()
            if i not in self._states:
                self._states[i] = optim.create_state(i, w)
            optim.update(i, w, param.grad(), self._states[i])

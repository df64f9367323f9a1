"""Module: symbol + executor + optimizer (the port of
``mxnet_tpu/module/module.py``).

Reference: python/mxnet/module/module.py (bind :364, init_params :474,
init_optimizer :575, forward :629, backward :646, update :658). The
reference's DataParallelExecutorGroup (executor_group.py:144 — per-GPU
executors, batch slicing, grad reduce via kvstore) is not reproduced, as
in the JAX package: one Executor on one device, bound on ``context``
(else ``current_context()``: the card unless a ``with mx.cpu():`` block
says otherwise). ``update()`` runs the optimizer's update op on each
parameter in place (on the card, the multi-tensor update kernel).
"""
from __future__ import annotations

import logging

import torch

from .. import initializer as init_mod
from .. import optimizer as opt_mod
from ..context import current_context
from ..io.io import DataDesc
from .base_module import BaseModule

__all__ = ["Module"]


class Module(BaseModule):
    """Single-program Module (reference: module.py:55)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        if isinstance(context, (list, tuple)):
            if len(context) > 1:
                logger.warning(
                    "Module(context=[...]): one executor on the first "
                    "context; multi-device data parallelism is not "
                    "reproduced")
            context = context[0] if context else None
        self._context = context
        self._symbol = symbol
        self._data_names = list(data_names) if data_names else []
        self._label_names = list(label_names) if label_names else []
        self._fixed_param_names = list(fixed_param_names or [])
        arg_names = symbol.list_arguments()
        self._param_names = [n for n in arg_names
                             if n not in self._data_names and
                             n not in self._label_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._data_shapes = None
        self._label_shapes = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """Create from a checkpoint (reference: module.py:125)."""
        from ..model import load_checkpoint
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = False
        mod._preloaded_params = (args, auxs)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        """symbol JSON + params blob (reference: module.py:165)."""
        from ..model import save_checkpoint
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self.symbol, arg_params, aux_params)
        if save_optimizer_states:
            state_name = f"{prefix}-{epoch:04d}.states"
            self.save_optimizer_states(state_name)

    # -------------------------------------------------------------- bind --
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        """Allocate the executor (reference: module.py:364)."""
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        shapes = {}
        for d in data_shapes:
            name, shape = (d.name, d.shape) if isinstance(d, DataDesc) \
                else (d[0], d[1])
            shapes[name] = shape
        if label_shapes:
            for d in label_shapes:
                name, shape = (d.name, d.shape) if isinstance(d, DataDesc) \
                    else (d[0], d[1])
                shapes[name] = shape
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        req = grad_req if for_training else "null"
        if isinstance(req, str):
            req_dict = {n: (req if n in self._param_names and
                            n not in self._fixed_param_names else "null")
                        for n in self._symbol.list_arguments()}
        else:
            req_dict = req
        ctx = self._context if self._context is not None \
            else current_context()
        self._exec = self._symbol.simple_bind(
            ctx=ctx, grad_req=req_dict, **shapes)
        self.binded = True
        if getattr(self, "_preloaded_params", None):
            args, auxs = self._preloaded_params
            self.set_params(args, auxs)
            self._preloaded_params = None

    # ------------------------------------------------------------ params --
    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Initialize parameter arrays (reference: module.py:474)."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None and (arg_params is None):
            initializer = init_mod.Uniform(0.01)
        # variable attrs (e.g. the ``__init__`` recorded by
        # ``sym.var(init=...)``) ride along on the InitDesc so cells can
        # pin per-parameter initializers (reference: module.py _impl
        # building InitDesc(name, attrs))
        attrs = self._symbol.attr_dict() \
            if hasattr(self._symbol, "attr_dict") else {}
        for name in self._param_names:
            arr = self._exec.arg_dict[name]
            if arg_params is not None and name in arg_params:
                arg_params[name].copyto(arr)
            elif initializer is not None:
                _init_array(initializer, name, attrs, arr)
            elif not allow_missing:
                raise RuntimeError(
                    f"Parameter '{name}' is not presented in arg_params "
                    "and no initializer was given (reference: "
                    "module.py init_params _impl)")
        for name in self._aux_names:
            arr = self._exec.aux_dict[name]
            if aux_params is not None and name in aux_params:
                aux_params[name].copyto(arr)
            elif initializer is not None:
                _init_array(initializer, name, attrs, arr)
        self.params_initialized = True

    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params = {n: self._exec.arg_dict[n].copy()
                      for n in self._param_names}
        aux_params = {n: self._exec.aux_dict[n].copy()
                      for n in self._aux_names}
        return arg_params, aux_params

    # --------------------------------------------------------- optimizer --
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Wire optimizer (reference: module.py:575). kvstore collapses
        to direct updates — see class docstring."""
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                # reference module.py:600: normalize by batch size
                batch_size = 0
                if self._data_shapes:
                    d = self._data_shapes[0]
                    shape = d.shape if isinstance(d, DataDesc) else d[1]
                    batch_size = shape[0]
                if batch_size:
                    optimizer_params["rescale_grad"] = 1.0 / batch_size
            idx2name = {i: n for i, n in enumerate(self._param_names)}
            optimizer = opt_mod.create(optimizer, param_idx2name=idx2name,
                                       **optimizer_params)
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True

    # ----------------------------------------------------------- compute --
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        feeds = {}
        for name, arr in zip(self._data_names, data_batch.data):
            feeds[name] = arr
        if data_batch.label is not None:
            for name, arr in zip(self._label_names, data_batch.label):
                if name in self._exec.arg_dict:
                    feeds[name] = arr
        self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """Apply optimizer to every parameter (reference: module.py:658)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        for i, name in enumerate(self._param_names):
            if self._exec.grad_req.get(name, "null") == "null":
                continue
            grad = self._exec.grad_dict.get(name)
            if grad is None:
                continue
            self._updater(i, grad._data, self._exec.arg_dict[name]._data)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self._exec.outputs)

    def install_monitor(self, mon):
        mon.install(self._exec)

    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "wb") as f:
            f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return [o.shape for o in self._exec.outputs]


def _init_array(initializer, name, attrs, arr):
    """Fill ``arr`` (an NDArray) by ``initializer`` for parameter
    ``name``: the initializer fills a CPU buffer, copied in."""
    buf = torch.zeros(arr.shape, dtype=torch.float32)
    initializer(init_mod.InitDesc(name, attrs.get(name)), buf)
    with torch.no_grad():
        arr._data.copy_(buf)

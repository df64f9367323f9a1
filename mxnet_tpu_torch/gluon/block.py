"""Gluon ``Block`` and ``HybridBlock`` of the port, on ``torch.nn.Module``
(mirrors ``mxnet_tpu/gluon/block.py``).

Names follow MXNet: every block gets a prefix from the enclosing
``name_scope()`` (``dense0_``, ``layer0_attn_query_`` ...) or from a
process-wide counter at the root, and its parameters are named
``prefix + name``. A child block assigned as an attribute, or passed to
:meth:`Block.register_child`, is an ``nn.Module`` child; a
:class:`~.parameter.Parameter` assigned as an attribute stays reachable
as that attribute (``self.weight.data()``) and its tensor is registered
as the module's ``nn.Parameter`` of the same name once it exists.
"""
from __future__ import annotations

import re
import threading

import numpy as np
import torch

from ..ndarray.ndarray import unwrap
from ..ops import nn as _F
from .parameter import DeferredInitializationError, Parameter, \
    ParameterDict

__all__ = ["Block", "HybridBlock"]


class _BlockScope:
    """Name scope for automatic ``prefix`` generation."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, hint):
        """(prefix, ParameterDict) of a block made in the current scope."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _name_counter(hint) + "_"
            return prefix, ParameterDict(prefix)
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = f"{hint}{count}_"
            current._counter[hint] = count + 1
        params = ParameterDict(current._block.params.prefix + prefix)
        return current._block.prefix + prefix, params

    def __enter__(self):
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        _BlockScope._current.value = self._old_scope


_GLOBAL_NAME_COUNTER = {}


def _name_counter(hint):
    count = _GLOBAL_NAME_COUNTER.get(hint, 0)
    _GLOBAL_NAME_COUNTER[hint] = count + 1
    return f"{hint}{count}"


class Block(torch.nn.Module):
    """Base building block: named parameters in ``self.params``, child
    blocks as ``nn.Module`` children, ``collect_params`` over the tree."""

    def __init__(self, prefix=None):
        super().__init__()
        self._prefix, self._params = _BlockScope.create(prefix,
                                                        self._alias())
        self._scope = _BlockScope(self)
        self._reg_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def __call__(self, *args, **kwargs):
        # NDArrays are unwrapped once, here: blocks compute on tensors
        return super().__call__(*unwrap(args), **unwrap(kwargs))

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is None:
                raise AttributeError(
                    "cannot assign a Parameter before Block.__init__()")
            if name in reg and reg[name] is not value:
                raise TypeError("Overriding Parameter attribute is not "
                                "allowed.")
            reg[name] = value
            value._attach(self, name)
            return
        super().__setattr__(name, value)

    def __getattr__(self, name):
        reg = self.__dict__.get("_reg_params")
        if reg is not None and name in reg:
            return reg[name]
        return super().__getattr__(name)

    def _apply(self, fn, recurse=True):
        ret = super()._apply(fn, recurse)
        for name, param in self._reg_params.items():
            t = self._parameters.get(name)
            if t is not None and t is not param._data:
                param._adopt(t)
        return ret

    @property
    def prefix(self):
        return self._prefix

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """The parameters of this block and every descendant, optionally
        only those whose name matches the regex ``select``."""
        ret = ParameterDict(self._params.prefix)
        pattern = re.compile(select) if select else None
        ret.update({name: value for name, value in self.params.items()
                    if pattern is None or pattern.match(name)})
        for child in self._modules.values():
            ret.update(child.collect_params(select=select))
        return ret

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._modules))
        self.add_module(name, block)

    def initialize(self, init=None, device=None, generator=None):
        """Initialize every parameter of the tree on ``device`` (default:
        the card); ``init`` (default ``Uniform()``) serves parameters
        without their own initializer. Draws come from ``generator``."""
        self.collect_params().initialize(init, device, generator)

    def cast(self, dtype):
        """Cast every parameter of the tree to ``dtype`` (see
        :meth:`.Parameter.cast`)."""
        for child in self._modules.values():
            child.cast(dtype)
        for param in self.params.values():
            param.cast(dtype)

    def _serving_device(self):
        """The device of the tree's parameters: of the first with data,
        else the one its deferred initialization names; the CPU for a
        block without parameters."""
        for p in self.collect_params().values():
            if p._data is not None:
                return p._data.device
            if p._deferred_init:
                return p._deferred_init[1]
        return torch.device("cpu")

    def serve(self, example_input=None, **server_kwargs):
        """Serve this block's forward directly through a
        :class:`mxnet_tpu_torch.serving.ModelServer`: dynamic
        micro-batching of concurrent requests, bucket padding, and on
        the card one CUDA graph per bucket, captured by ``warmup()``.

        ``example_input`` (a single sample, NO batch dim; numpy or a
        tensor) resolves any deferred parameter shapes and pins the
        server's item shape/dtype so ``warmup()`` works before the first
        request. Returns an **unstarted** server — call ``start()`` (or
        use it as a context manager)::

            with net.serve(example_input=x0, max_batch_size=16) as srv:
                srv.warmup()
                fut = srv.submit(x0)
        """
        from .. import autograd
        from ..serving import ModelServer
        if example_input is not None:
            ex = (example_input.detach().cpu().numpy()
                  if isinstance(example_input, torch.Tensor)
                  else np.asarray(example_input))
            with autograd.pause(train_mode=False):
                # resolve deferred shapes
                self(torch.from_numpy(ex[None]).to(self._serving_device()))
            server_kwargs.setdefault("item_shape", ex.shape)
            server_kwargs.setdefault("dtype", ex.dtype)
        return ModelServer(self, **server_kwargs)

    def hybridize(self, active=True, **kwargs):
        """Accepted for API parity; compiles nothing in this slice.

        Blocks run eagerly, one PyTorch call per operation. The JAX
        package traces a hybridized block into one XLA program; the
        port's counterpart (a CachedOp as a CUDA graph per input
        signature) is later work."""

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class HybridBlock(Block):
    """A Block written as ``hybrid_forward(F, x, *args, **params)``: ``F``
    is the port's operator namespace (:mod:`mxnet_tpu_torch.ops.nn`) and
    ``params`` this block's parameter tensors by attribute name.
    Deferred shapes are inferred from the first input
    (``_infer_param_shapes``)."""

    def _infer_param_shapes(self, *args):
        pass

    def forward(self, x, *args):
        try:
            params = {k: v.data() for k, v in self._reg_params.items()}
        except DeferredInitializationError:
            self._infer_param_shapes(x, *args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            params = {k: v.data() for k, v in self._reg_params.items()}
        return self.hybrid_forward(_F, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

"""Basic layers of the port (mirrors ``mxnet_tpu/gluon/nn/basic_layers.py``):
``Sequential``, ``HybridSequential``, ``Dense``, ``Activation``,
``Dropout``, ``Embedding``, ``BatchNorm``, ``InstanceNorm``,
``LayerNorm``, ``GroupNorm``, ``Flatten``, ``Lambda``, ``HybridLambda``,
``Concatenate``, ``HybridConcatenate`` and ``Identity``. Layers hold
parameters; the math is in :mod:`mxnet_tpu_torch.ops` (``F``).

``BatchNorm`` keeps the reference's running statistics: in training the
op returns the batch mean and biased variance and the layer sets
``running = running * momentum + batch * (1 - momentum)`` under
``autograd.pause()`` (torch's ``F.batch_norm`` would update them with
the unbiased variance and read its momentum as ``1 - momentum``).
"""
from __future__ import annotations

import math

from ... import autograd
from ...base import dtype_name
from ...ops.invoke import apply_op
from ..block import _F, Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "Dropout", "Embedding", "BatchNorm", "InstanceNorm", "LayerNorm",
           "GroupNorm", "Flatten", "Lambda", "HybridLambda", "Concatenate",
           "HybridConcatenate", "Identity"]


class _Stack:
    """``add``, ``len``, iteration and indexing (a slice: a new stack of
    the same class and prefix) over the children."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def __getitem__(self, key):
        layers = list(self._modules.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers


class Sequential(_Stack, Block):
    """Stack of blocks run in order."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x)
        return x


class HybridSequential(_Stack, HybridBlock):
    """Stack of hybrid blocks run in order."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """Fully-connected layer ``act(dot(x, W^T) + b)``, weight ``(units,
    in_units)``; ``in_units=0`` defers the weight's shape to the first
    forward."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._flatten = flatten
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def _infer_param_shapes(self, x, *args):
        if self._flatten:
            in_units = math.prod(x.shape[1:])
        else:
            in_units = x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight=None, bias=None):
        act = F.FullyConnected(x, weight, bias, flatten=self._flatten)
        if self.act is not None:
            act = self.act(act)
        return act

    def __repr__(self):
        shape = self.weight.shape
        return (f"Dense({shape[1] if shape[1] else None} -> {shape[0]}, "
                f"{'linear' if self.act is None else self.act._act_type})")


class Activation(HybridBlock):
    """Activation layer (``relu``, ``tanh``, ``gelu`` ...)."""

    def __init__(self, activation, prefix=None, params=None):
        self._act_type = activation
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return f"Activation({self._act_type})"


class Dropout(HybridBlock):
    """Dropout, active only under ``autograd.record()`` /
    ``train_mode()``, one mask entry shared along ``axes``; draws from
    ``generator`` (default: torch's generator of the input's device)."""

    def __init__(self, rate, axes=(), generator=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes
        self._generator = generator

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, generator=self._generator,
                         axes=self._axes)

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis`` with running statistics (kept in
    f32 under a 16-bit ``cast``); ``scale=False`` fixes gamma at 1."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        self._momentum = momentum
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def _infer_param_shapes(self, x, *args):
        ch = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p.shape = (ch,)

    def cast(self, dtype):
        if dtype_name(dtype) in ("float16", "bfloat16"):
            dtype = "float32"  # norm statistics stay f32, as the reference
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma=None, beta=None, running_mean=None,
                       running_var=None):
        if autograd.is_training() and not self._use_global_stats:
            out, mean, var = F.BatchNorm(
                x, gamma, beta, running_mean, running_var,
                output_mean_var=True, **self._kwargs)
            with autograd.pause():
                m = self._momentum
                self.running_mean.set_data(running_mean * m
                                           + mean * (1 - m))
                self.running_var.set_data(running_var * m + var * (1 - m))
            return out
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           **self._kwargs)

    def __repr__(self):
        in_channels = self.gamma.shape[0]
        return (f"BatchNorm(axis={self._axis}, eps={self._kwargs['eps']}, "
                f"momentum={self._momentum}, "
                f"in_channels={in_channels or None})")


class Embedding(HybridBlock):
    """Index → vector lookup, weight ``(input_dim, output_dim)``."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = sparse_grad
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim), dtype=dtype,
            init=weight_initializer, allow_deferred_init=True,
            grad_stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight=None):
        if self._sparse_grad:
            # under record the weight's gradient is row-sparse
            # (ops/invoke.py _SparseEmbedding)
            return apply_op("Embedding", [x, weight],
                            dict(input_dim=self._input_dim,
                                 output_dim=self._output_dim,
                                 sparse_grad=True))
        return F.Embedding(x, weight)

    def __repr__(self):
        return f"Embedding({self._input_dim} -> {self._output_dim})"


class Flatten(HybridBlock):
    """Flatten to ``(batch, -1)``."""

    def hybrid_forward(self, F, x):
        return x.reshape(x.shape[0], -1)

    def __repr__(self):
        return "Flatten"


class InstanceNorm(HybridBlock):
    """Instance normalization over the spatial axes of each channel
    (``axis`` the channel axis)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)

    def _infer_param_shapes(self, x, *args):
        ch = x.shape[self._axis]
        self.gamma.shape = (ch,)
        self.beta.shape = (ch,)

    def hybrid_forward(self, F, x, gamma=None, beta=None):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)
        x = x.swapaxes(1, self._axis)
        return F.InstanceNorm(x, gamma, beta,
                              eps=self._epsilon).swapaxes(1, self._axis)

    def __repr__(self):
        in_channels = self.gamma.shape[0]
        return (f"InstanceNorm(eps={self._epsilon}, axis={self._axis}, "
                f"in_channels={in_channels})")


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis`` (default eps 1e-5)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)

    def _infer_param_shapes(self, x, *args):
        ch = x.shape[self._axis]
        self.gamma.shape = (ch,)
        self.beta.shape = (ch,)

    def hybrid_forward(self, F, x, gamma=None, beta=None):
        return F.LayerNorm(x, gamma, beta, axis=self._axis,
                           eps=self._epsilon)

    def __repr__(self):
        in_channels = self.gamma.shape[0]
        return (f"LayerNorm(eps={self._epsilon}, axis={self._axis}, "
                f"in_channels={in_channels})")


class GroupNorm(HybridBlock):
    """Group normalization of channel axis 1 in ``num_groups`` groups."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_groups = num_groups
        self._epsilon = epsilon
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)

    def _infer_param_shapes(self, x, *args):
        ch = x.shape[1]
        self.gamma.shape = (ch,)
        self.beta.shape = (ch,)

    def hybrid_forward(self, F, x, gamma=None, beta=None):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._epsilon)

    def __repr__(self):
        return (f"GroupNorm(groups={self._num_groups}, "
                f"eps={self._epsilon})")


def _nd_function(function):
    """The ``nd`` function of that name, on tensors (an ``nd`` function
    returns NDArrays; blocks compute on tensors)."""
    from ... import ndarray as nd
    from ...ndarray.ndarray import unwrap
    if not hasattr(nd, function):
        raise AssertionError(f"Function name {function} is not found in "
                             "ndarray.")
    fn = getattr(nd, function)
    return lambda *args: unwrap(fn(*args))


class Lambda(Block):
    """A function, or the name of an ``nd`` function, as a Block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func_impl = _nd_function(function)
            self._func_name = function
        elif callable(function):
            self._func_impl = function
            self._func_name = function.__name__
        else:
            raise ValueError("Unrecognized function in lambda")

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return f"Lambda({self._func_name})"


class HybridLambda(HybridBlock):
    """A function ``fn(F, x, *args)``, or the name of an ``F`` op, as a
    HybridBlock."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            _nd_function(function)      # the reference's name check
            self._func = lambda F, *args: getattr(F, function)(*args)
            self._func_name = function
        elif callable(function):
            self._func = function
            self._func_name = function.__name__
        else:
            raise ValueError("Unrecognized function in lambda")

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return f"HybridLambda({self._func_name})"


class Concatenate(Sequential):
    """Runs every child on the same input and concatenates the outputs
    along ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return _F.concat(*[block(x) for block in self._modules.values()],
                         dim=self.axis)


class HybridConcatenate(HybridSequential):
    """:class:`Concatenate` of hybrid blocks."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x, *args):
        return _F.concat(*[block(x) for block in self._modules.values()],
                         dim=self.axis)


class Identity(HybridBlock):
    """Its input, unchanged."""

    def hybrid_forward(self, F, x):
        return x

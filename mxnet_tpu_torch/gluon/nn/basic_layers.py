"""Basic layers of the port (mirrors ``mxnet_tpu/gluon/nn/basic_layers.py``):
``HybridSequential``, ``Dense``, ``Activation``, ``Dropout``,
``Embedding`` and ``LayerNorm``. Layers hold parameters; the math is in
:mod:`mxnet_tpu_torch.ops.nn`.
"""
from __future__ import annotations

import math

from ..block import HybridBlock

__all__ = ["HybridSequential", "Dense", "Activation", "Dropout",
           "Embedding", "LayerNorm"]


class HybridSequential(HybridBlock):
    """Stack of blocks run in order."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """Fully-connected layer ``act(dot(x, W^T) + b)``, weight ``(units,
    in_units)``; ``in_units=0`` defers the weight's shape to the first
    forward."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None):
        super().__init__(prefix=prefix)
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


class Activation(HybridBlock):
    """Activation layer (``relu``, ``tanh``, ``gelu``)."""

    def __init__(self, activation, prefix=None):
        self._act_type = activation
        super().__init__(prefix=prefix)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class Dropout(HybridBlock):
    """Dropout, active only under ``autograd.record()`` /
    ``train_mode()``; draws from ``generator`` (default: torch's
    generator of the input's device)."""

    def __init__(self, rate, generator=None, prefix=None):
        super().__init__(prefix=prefix)
        self._rate = rate
        self._generator = generator

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, generator=self._generator)


class Embedding(HybridBlock):
    """Index → vector lookup, weight ``(input_dim, output_dim)``."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, prefix=None):
        super().__init__(prefix=prefix)
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim), dtype=dtype,
            init=weight_initializer, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight=None):
        return F.Embedding(x, weight)


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis`` (default eps 1e-5)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None):
        super().__init__(prefix=prefix)
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

"""Weight initializers of the port (mirrors ``mxnet_tpu/initializer.py``).

An initializer fills a CPU tensor in place, dispatching on the
parameter's name as MXNet does: ``*weight`` → the weight rule,
``*bias``/``*beta`` → zeros, ``*gamma`` → ones, ``*running_mean`` /
``*moving_mean``, ``*min`` and ``*max`` → zeros, ``*running_var`` /
``*moving_var`` → ones, any other name (BERT's ``position_embed``,
PReLU's ``alpha``) → ``_init_default``, the weight rule. Random draws
come from the ``generator`` passed at the call (torch's default CPU
generator when it is None), so values do not depend on the device the
parameter lands on.
"""
from __future__ import annotations

import math

__all__ = ["Initializer", "register", "create", "Zero", "One", "Constant",
           "Uniform", "Normal", "Xavier"]

_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An initializer instance from itself or its registered name."""
    if isinstance(name, Initializer):
        return name
    return _INIT_REGISTRY[name.lower()](**kwargs)


class Initializer:
    """Base initializer: ``init(name, arr, generator=None)``."""

    def __call__(self, name, arr, generator=None):
        if name.endswith("weight"):
            self._init_weight(name, arr, generator)
        elif name.endswith(("bias", "beta", "running_mean", "moving_mean",
                            "min", "max")):
            arr.fill_(0.0)
        elif name.endswith(("gamma", "running_var", "moving_var")):
            arr.fill_(1.0)
        else:
            self._init_default(name, arr, generator)

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError()

    def _init_default(self, name, arr, generator):
        self._init_weight(name, arr, generator)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr, generator):
        arr.fill_(0.0)


_INIT_REGISTRY["zeros"] = Zero


@register
class One(Initializer):
    def _init_weight(self, _, arr, generator):
        arr.fill_(1.0)


_INIT_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    """Every weight ``value``."""

    def __init__(self, value=0.0):
        self.value = value

    def _init_weight(self, _, arr, generator):
        arr.fill_(self.value)


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, _, arr, generator):
        arr.uniform_(-self.scale, self.scale, generator=generator)


@register
class Normal(Initializer):
    """N(0, sigma)."""

    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, _, arr, generator):
        arr.normal_(0.0, self.sigma, generator=generator)


@register
class Xavier(Initializer):
    """Glorot: scale ``sqrt(magnitude / factor)`` with the average, in or
    out fan as ``factor``."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr, generator):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError(
                f"Xavier initializer cannot be applied to vector {name}. "
                "It requires at least 2D.")
        hw_scale = math.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise ValueError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr.uniform_(-scale, scale, generator=generator)
        elif self.rnd_type == "gaussian":
            arr.normal_(0.0, scale, generator=generator)
        else:
            raise ValueError("Unknown random type")

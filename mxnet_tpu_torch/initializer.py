"""Weight initializers of the port (mirrors ``mxnet_tpu/initializer.py``).

An initializer fills a CPU tensor in place, dispatching on the
parameter's name as MXNet does: ``*weight`` → the weight rule,
``*bias`` → ``_init_bias``, ``*beta`` → zeros, ``*gamma`` → ones,
``*running_mean`` / ``*moving_mean``, ``*min`` and ``*max`` → zeros,
``*running_var`` / ``*moving_var`` → ones, any other name (BERT's
``position_embed``, PReLU's ``alpha``) → ``_init_default``, the weight
rule. An :class:`InitDesc` name whose ``attrs`` hold ``__init__`` (a
dumped initializer) takes that initializer's weight rule instead. Random
draws come from the ``generator`` passed at the call (torch's default
CPU generator when it is None), so values do not depend on the device
the parameter lands on; they are not the JAX package's numbers, and its
tests hold the drawing initializers by their properties.

The reference's set: ``Zero``, ``One``, ``Constant``, ``Uniform``,
``Normal``, ``Orthogonal``, ``Xavier``, ``MSRAPrelu``, ``Bilinear``,
``LSTMBias``, ``FusedRNN`` (the flat vector of the fused RNN op, in
``ops/rnn.py``'s layout), ``Mixed`` (by name pattern) and ``Load`` (from
arrays by name).
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

__all__ = ["InitDesc", "Initializer", "register", "create", "Zero", "One",
           "Constant", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Bilinear", "LSTMBias", "FusedRNN", "Mixed", "Load"]

_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An initializer from itself (any callable), its registered name, a
    :meth:`Initializer.dumps` payload, or None (``Uniform()``)."""
    if name is None:
        return Uniform()
    if not isinstance(name, str):
        return name
    if name.startswith("["):
        klass, dumped_kwargs = json.loads(name)
        return _INIT_REGISTRY[klass.lower()](**dumped_kwargs)
    return _INIT_REGISTRY[name.lower()](**kwargs)


class InitDesc(str):
    """A parameter's name with its ``attrs`` and the global initializer
    that called for it."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer: ``init(name, arr, generator=None)``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self._verbose = False
        self._print_func = None

    def set_verbosity(self, verbose=False, print_func=None):
        """Keep the verbosity settings (the JAX package's; it prints
        nothing either); returns the initializer."""
        self._verbose = verbose
        self._print_func = print_func or (lambda x: None)
        return self

    def dumps(self):
        """``[name, kwargs]`` as JSON (:func:`create` reads it back)."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, name, arr, generator=None):
        if not isinstance(name, str):
            raise TypeError("desc must be an initialization name string")
        if isinstance(name, InitDesc) and name.global_init is None:
            name.global_init = self
        init = getattr(name, "attrs", {}).get("__init__", "")
        if init:
            create(init)._init_weight(name, arr, generator)
        elif name.endswith("weight"):
            self._init_weight(name, arr, generator)
        elif name.endswith("bias"):
            self._init_bias(name, arr, generator)
        elif name.endswith(("beta", "running_mean", "moving_mean", "min",
                            "max")):
            arr.fill_(0.0)
        elif name.endswith(("gamma", "running_var", "moving_var")):
            arr.fill_(1.0)
        else:
            self._init_default(name, arr, generator)

    def _init_bias(self, name, arr, generator):
        arr.fill_(0.0)

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError()

    def _init_default(self, name, arr, generator):
        self._init_weight(name, arr, generator)

    def __repr__(self):
        return f"{self.__class__.__name__}({getattr(self, '_kwargs', {})})"


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
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr, generator):
        arr.fill_(self.value)


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr, generator):
        arr.uniform_(-self.scale, self.scale, generator=generator)


@register
class Normal(Initializer):
    """N(0, sigma)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr, generator):
        arr.normal_(0.0, self.sigma, generator=generator)


@register
class Orthogonal(Initializer):
    """``scale`` times an orthonormal factor (of the SVD) of a uniform or
    normal ``(rows, prod(rest))`` draw: its rows, or its columns where
    the matrix is tall, are orthonormal."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr, generator):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:]) if arr.ndim > 1 else 1
        tmp = torch.empty((nout, nin), dtype=torch.float64)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(0.0, 1.0, generator=generator)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr.copy_((self.scale * q).reshape(arr.shape))


@register
class Xavier(Initializer):
    """Glorot: scale ``sqrt(magnitude / factor)`` with the average, in or
    out fan as ``factor``."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
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


@register
class MSRAPrelu(Xavier):
    """He (Kaiming) initialization for a PReLU of slope ``slope``: Xavier
    gaussian with magnitude ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel (a deconvolution's weight, NCHW)."""

    def _init_weight(self, _, arr, generator):
        shape = arr.shape
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(math.prod(shape))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c)))
        arr.copy_(torch.from_numpy(weight.astype(np.float32)
                                   .reshape(shape)))


@register
class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter ``forget_bias`` (the
    ``i, f, c, o`` gate order)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr, generator):
        arr.fill_(0.0)
        num_hidden = int(arr.shape[0] / 4)
        arr[num_hidden:2 * num_hidden] = self.forget_bias

    _init_default = _init_weight
    _init_bias = _init_weight


_RNN_GATES = {"rnn_relu": ("",), "rnn_tanh": ("",),
              "lstm": ("_i", "_f", "_c", "_o"), "gru": ("_r", "_z", "_o")}


def _rnn_weight_slices(prefix, mode, num_hidden, num_layers, bidirectional,
                       input_size):
    """(name, start, stop, shape) over the fused RNN op's flat vector
    (``ops/rnn.py``'s layout: every [Wx, Wh] block layer-major,
    direction-minor, then every [bx, bh] block), with the per-gate names
    of the reference's unfused cells."""
    gates = _RNN_GATES[mode]
    g, h = len(gates), num_hidden
    dirs = ("l", "r") if bidirectional else ("l",)
    off = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else h * len(dirs)
        for dname in dirs:
            cell = f"{prefix}{dname}{layer}_"
            for j, gate in enumerate(gates):
                yield (f"{cell}i2h{gate}_weight", off + j * h * in_sz,
                       off + (j + 1) * h * in_sz, (h, in_sz))
            off += g * h * in_sz
            for j, gate in enumerate(gates):
                yield (f"{cell}h2h{gate}_weight", off + j * h * h,
                       off + (j + 1) * h * h, (h, h))
            off += g * h * h
    for layer in range(num_layers):
        for dname in dirs:
            cell = f"{prefix}{dname}{layer}_"
            for group in ("i2h", "h2h"):
                for gate in gates:
                    yield (f"{cell}{group}{gate}_bias", off, off + h, (h,))
                    off += h


def _rnn_input_size(flat_size, mode, num_hidden, num_layers, bidirectional):
    """The layer-0 input width whose flat vector has ``flat_size``
    entries."""
    from .ops.rnn import rnn_param_size
    g, h = len(_RNN_GATES[mode]), num_hidden
    d = 2 if bidirectional else 1
    per_rest = (num_layers - 1) * d * (g * h * (h * d + h) + 2 * g * h)
    layer0 = flat_size - per_rest
    input_size = (layer0 - d * (g * h * h + 2 * g * h)) // (d * g * h)
    assert rnn_param_size(input_size, h, num_layers, mode,
                          bidirectional) == flat_size, \
        f"parameter vector size {flat_size} does not match any input " \
        "width for this cell"
    return input_size


@register
class FusedRNN(Initializer):
    """The flat parameter vector of a fused RNN op: each weight block
    through ``init`` (else the calling global initializer, else
    ``Xavier()``), biases zero, and for an LSTM every forget-gate bias
    ``forget_bias``."""

    def __init__(self, init=None, num_hidden=0, num_layers=1, mode="lstm",
                 bidirectional=False, forget_bias=1.0):
        if init is not None and not isinstance(init, str):
            init = init.dumps()
        super().__init__(init=init, num_hidden=num_hidden,
                         num_layers=num_layers, mode=mode,
                         bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = create(init) if init is not None else None
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr, generator):
        name = str(desc)
        prefix = name[:-len("parameters")] \
            if name.endswith("parameters") else name
        flat = arr.reshape(-1)
        input_size = _rnn_input_size(flat.numel(), self._mode,
                                     self._num_hidden, self._num_layers,
                                     self._bidirectional)
        inner = self._init or getattr(desc, "global_init", None) or Xavier()
        for pname, start, stop, shape in _rnn_weight_slices(
                prefix, self._mode, self._num_hidden, self._num_layers,
                self._bidirectional, input_size):
            buf = torch.zeros(shape, dtype=flat.dtype)
            if pname.endswith("_bias"):
                if self._mode == "lstm" and pname.endswith("_f_bias"):
                    buf.fill_(self._forget_bias)
            else:
                inner(InitDesc(pname), buf, generator)
            flat[start:stop] = buf.reshape(-1)
        arr.copy_(flat.reshape(arr.shape))

    _init_default = _init_weight


@register
class Mixed(Initializer):
    """The initializer of the first pattern (a regular expression) that
    matches the name."""

    def __init__(self, patterns, initializers):
        super().__init__()
        assert len(patterns) == len(initializers)
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr, generator=None):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr, generator)
                return
        raise ValueError(
            f"Parameter name {name} did not match any pattern. Consider "
            'adding a ".*" pattern at the end with default Initializer.')


@register
class Load:
    """Values from ``param`` (name → array; ``arg:``/``aux:`` prefixes
    dropped), ``default_init`` for the names it lacks."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {k[4:] if k.startswith(("arg:", "aux:")) else k: v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr, generator=None):
        if name in self.param:
            src = self.param[name]
            src = getattr(src, "_data", src)
            src = src.detach().cpu() if isinstance(src, torch.Tensor) \
                else torch.from_numpy(np.asarray(src))
            assert tuple(arr.shape) == tuple(src.shape), \
                f"Parameter {name} cannot be initialized from loading. " \
                f"Shape mismatch, target {tuple(arr.shape)} vs loaded " \
                f"{tuple(src.shape)}"
            arr.copy_(src)
        else:
            assert self.default_init is not None, \
                f"Cannot Initialize parameter: {name}, not found in " \
                "loaded param and no default initializer."
            self.default_init(name, arr, generator)

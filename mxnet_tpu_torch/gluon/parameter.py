"""Gluon ``Parameter`` and ``ParameterDict`` of the port (mirrors
``mxnet_tpu/gluon/parameter.py``).

A :class:`Parameter` is MXNet's named, lazily shaped parameter; its data
is one ``torch.nn.Parameter`` on one device, created by ``initialize``
(or, for a shape with a 0 such as ``Dense``'s ``(units, 0)``, on the
first forward). The blocks that hold it as an attribute register that
``nn.Parameter`` with ``nn.Module`` once it exists, so ``.to(device)``,
``named_parameters()`` and autograd see it.

Gradients keep MXNet's ``grad_req``:

- ``"write"`` — each ``backward()`` replaces the gradient (a hook on the
  tensor clears ``.grad`` before autograd accumulates into it; torch
  alone would add);
- ``"add"`` — gradients accumulate, as torch's do;
- ``"null"`` — no gradient (``requires_grad=False``).

``grad()`` starts as zeros, as MXNet's gradient buffer does, so a
parameter no backward reaches keeps a zero (or its last) gradient.

:func:`param_values` substitutes other tensors for parameters' data on
the calling thread (the reference's ``functional_call`` substitution):
``ModelServer`` serves a block from its own snapshot that way.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from collections import OrderedDict

import torch

from .. import initializer
from .._device import resolve_device
from ..ndarray.ndarray import unwrap

__all__ = ["DeferredInitializationError", "Parameter", "ParameterDict",
           "param_values"]

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64}

# {Parameter: tensor} that data() returns on this thread instead of the
# parameter's own tensor (None outside a param_values scope)
_SUBSTITUTES = threading.local()


@contextlib.contextmanager
def param_values(values):
    """Within the block, on the calling thread only, each
    :class:`Parameter` key of ``values`` reads (``data()``) as its
    tensor; other threads keep reading the parameters' own data."""
    prev = getattr(_SUBSTITUTES, "values", None)
    _SUBSTITUTES.values = values
    try:
        yield
    finally:
        _SUBSTITUTES.values = prev


class DeferredInitializationError(RuntimeError):
    """A parameter's data was asked for before its shape was known."""


class Parameter:
    """A Block parameter: named, lazily shaped, on one device."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False):
        self.name = name
        if shape is not None and not isinstance(shape, (tuple, list)):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._allow_deferred_init = allow_deferred_init
        self._data = None            # torch.nn.Parameter once initialized
        self._grad_req = None
        self.grad_req = grad_req
        # (init, device, data or None, generator) until the data exists
        self._deferred_init = ()
        # blocks holding this parameter: (weakref to block, attribute)
        self._owners = []

    # ------------------------------------------------------------- props --
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError(f"grad_req must be write/add/null, got {req}")
        prev, self._grad_req = self._grad_req, req
        if self._data is not None:
            self._data.requires_grad_(req != "null")
            if req == "null":
                self._data.grad = None
            elif prev == "null":
                self._adopt(self._data)   # the write hook needs the grad

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is None:
            self._shape = new_shape
            return
        # unknown (0) dims merge with the new shape's
        if not (len(self._shape) == len(new_shape) and all(
                j in (0, i) or i == 0
                for i, j in zip(new_shape, self._shape))):
            raise ValueError(
                f"Expected shape {new_shape} is incompatible with given "
                f"shape {self._shape} for Parameter {self.name}")
        self._shape = tuple(n if o == 0 else o
                            for o, n in zip(self._shape, new_shape))

    # -------------------------------------------------------------- init --
    def initialize(self, init=None, device=None, default_init=None,
                   generator=None):
        """Materialise the data on ``device`` (default: the card) with
        ``init`` (else this parameter's own ``init``, else
        ``default_init``, else ``Uniform()``); deferred until the first
        forward while the shape has a 0. A no-op once initialized."""
        if self._data is not None:
            return
        device = resolve_device("cuda" if device is None else device)
        if init is None:
            init = self.init if self.init is not None else default_init
        self._deferred_init = (init or initializer.Uniform(), device, None,
                               generator)
        if self._shape is None or 0 in self._shape:
            if self._allow_deferred_init:
                return
            self._deferred_init = ()
            raise ValueError(f"Cannot initialize Parameter '{self.name}' "
                             f"because it has invalid shape: {self._shape}.")
        self._finish_deferred_init()

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, device, data, generator = self._deferred_init
        if self._shape is None or 0 in self._shape:
            raise DeferredInitializationError(
                f"Parameter {self.name} has unresolved shape {self._shape}")
        if data is None:
            data = torch.zeros(self._shape, dtype=_DTYPES[self.dtype])
            initializer.create(init)(self.name, data, generator)
        p = torch.nn.Parameter(
            data.to(device=device, dtype=_DTYPES[self.dtype]).clone(),
            requires_grad=self._grad_req != "null")
        if self._grad_req != "null":
            p.grad = torch.zeros_like(p)
        self._adopt(p)
        self._deferred_init = ()

    def _adopt(self, p):
        """Make ``p`` this parameter's data (also after ``nn.Module``
        replaced the tensor, e.g. in a ``.to()`` across devices)."""
        ref = weakref.ref(self)

        def write_hook(grad):
            # grad_req="write": this backward's gradient replaces the last
            owner = ref()
            if owner is not None and owner._grad_req == "write":
                p.grad = None
            return grad
        if p.requires_grad:             # grad_req "null" takes no hook
            p.register_hook(write_hook)
        self._data = p
        for block_ref, attr in self._owners:
            block = block_ref()
            if block is not None:
                block._parameters[attr] = p

    def _attach(self, block, attr):
        self._owners.append((weakref.ref(block), attr))
        block._parameters[attr] = self._data

    # -------------------------------------------------------------- data --
    def data(self):
        """The parameter's ``torch.nn.Parameter`` (or, inside
        :func:`param_values`, the tensor substituted for it)."""
        values = getattr(_SUBSTITUTES, "values", None)
        if values is not None:
            sub = values.get(self)
            if sub is not None:
                return sub
        if self._data is not None:
            return self._data
        if self._deferred_init:
            raise DeferredInitializationError(
                f"Parameter '{self.name}' has not been initialized yet "
                "because initialization was deferred. Actual "
                "initialization happens during the first forward pass.")
        raise RuntimeError(
            f"Parameter '{self.name}' has not been initialized. Initialize "
            "it (or the block's collect_params()) first.")

    def grad(self):
        """The gradient tensor (zeros until a backward writes it)."""
        d = self.data()
        if self._grad_req == "null":
            raise RuntimeError(
                f"Cannot get gradient array for Parameter '{self.name}' "
                "because grad_req='null'")
        if d.grad is None:
            d.grad = torch.zeros_like(d)
        return d.grad

    def cast(self, dtype):
        """Cast the data (and a fresh zero gradient) to ``dtype`` (a name
        of ``float32``, ``float16``, ``bfloat16``, ``float64`` or a torch
        dtype); a parameter without data yet is made in ``dtype``."""
        if isinstance(dtype, torch.dtype):
            dtype = next(n for n, t in _DTYPES.items() if t == dtype)
        if dtype not in _DTYPES:
            raise ValueError(f"cannot cast Parameter '{self.name}' to "
                             f"{dtype!r}")
        self.dtype = dtype
        if self._data is None:
            return
        p = torch.nn.Parameter(self._data.detach().to(_DTYPES[dtype]),
                               requires_grad=self._grad_req != "null")
        if self._grad_req != "null":
            p.grad = torch.zeros_like(p)
        self._adopt(p)

    def set_data(self, data):
        """Copy ``data`` into the parameter (kept for the deferred init
        while the parameter has no data yet)."""
        data = torch.as_tensor(unwrap(data))
        self.shape = data.shape
        if self._data is not None:
            with torch.no_grad():
                self._data.copy_(data)
            return
        if not self._deferred_init:
            raise RuntimeError(
                f"Parameter '{self.name}' has not been initialized")
        init, device, _, generator = self._deferred_init
        self._deferred_init = (init, device, data, generator)


class ParameterDict:
    """Ordered dict of Parameters under a shared name prefix."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = OrderedDict()

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def get(self, name, **kwargs):
        """Get-or-create the parameter ``prefix + name``; an existing one
        takes a ``shape`` that fills its unknown (0) dims."""
        name = self._prefix + name
        param = self._params.get(name)
        if param is None:
            param = self._params[name] = Parameter(name, **kwargs)
        elif kwargs.get("shape") is not None:
            param.shape = kwargs["shape"]
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(
                    f"Cannot update self with other because they have "
                    f"different Parameters with the same name '{k}'")
            self._params[k] = v

    def initialize(self, init=None, device=None, generator=None):
        """Initialize every parameter: ``init`` is the default for those
        without their own initializer."""
        for v in self._params.values():
            v.initialize(None, device, init, generator=generator)

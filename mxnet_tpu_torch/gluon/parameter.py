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

A parameter with ``grad_stype="row_sparse"`` (``Embedding(sparse_grad=
True)``) gets a sparse gradient from its lookups: ``grad()`` returns it
as an ``nd.sparse.RowSparseNDArray`` (dense zeros before any backward).
``row_sparse_data(row_id)`` gathers the rows of a ``stype="row_sparse"``
parameter's (dense) data as a RowSparseNDArray.

One device a parameter: ``list_data``, ``list_grad`` and ``list_ctx``
return lists of one, and ``reset_ctx`` moves the data. ``var()`` waits
for ``symbol/`` (ROADMAP.md §1 item 14) and raises
``NotImplementedError``.

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

import numpy as np

from .. import initializer
from .._device import resolve_device
from ..base import dtype_name, torch_dtype
from ..ndarray.ndarray import unwrap

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict", "param_values", "substituted", "track_access"]

# {Parameter: tensor} that data() returns on this thread instead of the
# parameter's own tensor (None outside a param_values scope)
_SUBSTITUTES = threading.local()
# the _Access of the track_access scope on this thread, if any
_ACCESS = threading.local()


def substituted():
    """True inside a :func:`param_values` scope on this thread."""
    return getattr(_SUBSTITUTES, "values", None) is not None


class _Access:
    """What a :func:`track_access` scope saw: ``reads`` (the parameters
    whose data was read), ``saved`` (each parameter written through
    ``set_data``, with a copy of its data before the first write) and
    ``suppress`` (while set, ``set_data`` writes nothing)."""

    __slots__ = ("reads", "saved", "suppress")

    def __init__(self, suppress=False):
        self.reads = set()
        self.saved = {}
        self.suppress = suppress

    def restore(self):
        """Put back what the scope's writes replaced."""
        with torch.no_grad():
            for p, old in self.saved.items():
                p._data.copy_(old)
        self.saved.clear()


@contextlib.contextmanager
def track_access(access=None):
    """On this thread, record into ``access`` (a new ``_Access`` by
    default; yielded) the parameters read and written in the scope. A
    compiled region (a hybridized block's graph, a compiled training
    step) reads its parameters by address: the reads say which addresses
    its graph depends on, and the saved writes let its warm run be
    undone."""
    prev = getattr(_ACCESS, "rec", None)
    _ACCESS.rec = access = access if access is not None else _Access()
    try:
        yield access
    finally:
        _ACCESS.rec = prev


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
    """A Block parameter: named, lazily shaped, on one device.
    ``differentiable=False`` holds ``grad_req`` at ``"null"``; ``stype``
    and ``grad_stype`` are kept for the reference's signature (storage
    is dense; a ``grad_stype="row_sparse"`` parameter's gradient is
    sparse)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        if shape is not None and not isinstance(shape, (tuple, list)):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype_name(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self.stype = stype
        self.grad_stype = grad_stype
        self._data = None            # torch.nn.Parameter once initialized
        self._grad_req = None
        self.grad_req = grad_req
        # (init, device, data or None, generator) until the data exists
        self._deferred_init = ()
        # blocks holding this parameter: (weakref to block, attribute)
        self._owners = []

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")

    # ------------------------------------------------------------- props --
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError(f"grad_req must be write/add/null, got {req}")
        if not self._differentiable:
            req = "null"
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
                   generator=None, force_reinit=False, ctx=None):
        """Materialise the data on ``device`` (or ``ctx``, the reference's
        name: a Context, string or ``torch.device``; default: the
        innermost ``with Context`` block's, else the card) with
        ``init`` (else this parameter's own ``init``, else
        ``default_init``, else ``Uniform()``); deferred until the first
        forward while the shape has a 0. A no-op once initialized, unless
        ``force_reinit``, which draws new data (a new tensor: CUDA graphs
        over the old one must be dropped, as ``Block.initialize`` does)."""
        device = ctx if device is None else device
        if self._data is not None:
            if not force_reinit:
                return
            if device is None:
                device = self._data.device
        device = resolve_device(device)
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
            data = torch.zeros(self._shape, dtype=torch_dtype(self.dtype))
            initializer.create(init)(self.name, data, generator)
        p = torch.nn.Parameter(
            data.to(device=device, dtype=torch_dtype(self.dtype)).clone(),
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
        access = getattr(_ACCESS, "rec", None)
        if access is not None:
            access.reads.add(self)
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

    def list_data(self):
        """The data, as a list of one (one device)."""
        return [self.data()]

    def grad(self):
        """The gradient tensor (zeros until a backward writes it); a
        sparse gradient as a RowSparseNDArray."""
        d = self.data()
        if self._grad_req == "null":
            raise RuntimeError(
                f"Cannot get gradient array for Parameter '{self.name}' "
                "because grad_req='null'")
        if d.grad is None:
            d.grad = torch.zeros_like(d)
        if d.grad.is_sparse:
            from ..ndarray.sparse import RowSparseNDArray
            return RowSparseNDArray.from_coo(d.grad)
        return d.grad

    def list_grad(self):
        """The gradient, as a list of one (one device)."""
        return [self.grad()]

    def zero_grad(self):
        """Set the gradient to zero in place (nothing without data or a
        gradient)."""
        if self._data is not None and self._data.grad is not None:
            with torch.no_grad():
                self._data.grad.zero_()

    def list_ctx(self):
        """The device the data is on (or will be, while deferred), as a
        list of one."""
        if self._data is not None:
            return [self._data.device]
        if self._deferred_init:
            return [self._deferred_init[1]]
        raise RuntimeError(f"Parameter '{self.name}' has not been "
                           "initialized")

    def reset_ctx(self, ctx):
        """Move the data (and a fresh zero gradient) to device ``ctx``; a
        deferred parameter is made there."""
        device = resolve_device(ctx)
        if self._data is not None:
            p = torch.nn.Parameter(self._data.detach().to(device),
                                   requires_grad=self._grad_req != "null")
            if self._grad_req != "null":
                p.grad = torch.zeros_like(p)
            self._adopt(p)
        elif self._deferred_init:
            init, _, data, generator = self._deferred_init
            self._deferred_init = (init, device, data, generator)
        else:
            raise ValueError(f"Cannot reset context for Parameter "
                             f"'{self.name}' because it has not been "
                             "initialized.")

    def var(self):
        """The reference's Symbol variable: ``symbol/`` is not ported."""
        raise NotImplementedError(
            "Parameter.var needs mxnet_tpu.symbol, not ported yet "
            "(ROADMAP.md §1 item 14)")

    def row_sparse_data(self, row_id):
        """The rows ``row_id`` names (each once, sorted) of a
        ``stype="row_sparse"`` parameter, gathered into a
        RowSparseNDArray of the parameter's shape (the storage stays
        dense)."""
        if self.stype != "row_sparse":
            raise RuntimeError(
                f"Parameter '{self.name}' stype is {self.stype!r}; "
                "row_sparse_data requires stype='row_sparse'")
        from ..ndarray.sparse import RowSparseNDArray
        src = self.data().detach()
        rows = torch.unique(torch.as_tensor(
            unwrap(row_id)).to(src.device).long().reshape(-1))
        return RowSparseNDArray(src[rows], rows, tuple(src.shape))

    def list_row_sparse_data(self, row_id):
        return [self.row_sparse_data(row_id)]

    def cast(self, dtype):
        """Cast the data (and a fresh zero gradient) to ``dtype`` (a dtype
        name, a numpy or a torch dtype); a parameter without data yet is
        made in ``dtype``."""
        self.dtype = dtype_name(dtype)
        if self._data is None:
            return
        p = torch.nn.Parameter(
            self._data.detach().to(torch_dtype(self.dtype)),
            requires_grad=self._grad_req != "null")
        if self._grad_req != "null":
            p.grad = torch.zeros_like(p)
        self._adopt(p)

    def _load(self, value, ctx=None):
        """Take ``value`` (a loaded tensor) as the data, in this
        parameter's dtype: copied into the data, or, without data yet,
        materialised on ``ctx`` (else the device its ``initialize``
        named, else the card)."""
        if self._data is not None:
            self.set_data(value)
            return
        self.shape = value.shape
        if self._deferred_init:
            init, device, _, generator = self._deferred_init
        else:
            init, device, generator = None, None, None
        if ctx is not None or device is None:
            device = resolve_device(ctx)
        self._deferred_init = (init, device, value, generator)
        self._finish_deferred_init()

    def set_data(self, data):
        """Copy ``data`` into the parameter (kept for the deferred init
        while the parameter has no data yet)."""
        data = torch.as_tensor(unwrap(data))
        self.shape = data.shape
        if self._data is not None:
            access = getattr(_ACCESS, "rec", None)
            if access is not None:
                if access.suppress:
                    return
                if self not in access.saved:
                    access.saved[self] = self._data.detach().clone()
            with torch.no_grad():
                self._data.copy_(data)
            return
        if not self._deferred_init:
            raise RuntimeError(
                f"Parameter '{self.name}' has not been initialized")
        init, device, _, generator = self._deferred_init
        self._deferred_init = (init, device, data, generator)


class Constant(Parameter):
    """A non-trainable parameter holding ``value`` (``grad_req="null"``),
    initialized to it whatever the initializer given."""

    def __init__(self, name, value):
        value = np.asarray(value.detach().cpu() if isinstance(
            value, torch.Tensor) else unwrap(value))
        self.value = value

        class ConstInit(initializer.Initializer):
            def _init_weight(self, _, arr, generator):
                arr.copy_(torch.from_numpy(np.array(value)))

            _init_default = _init_weight

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, differentiable=False,
                         init=ConstInit())


class ParameterDict:
    """Ordered dict of Parameters under a shared name prefix; ``shared``
    (another ParameterDict) lends its parameters by name."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __repr__(self):
        s = "\n".join(f"  {v}" for v in self._params.values())
        return f"ParameterDict '{self._prefix}' (\n{s}\n)"

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """Get-or-create the parameter ``prefix + name`` (from the
        shared dict too); an existing one takes a ``shape`` that fills
        its unknown (0) dims and must agree on the other attributes
        given."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = self._params[name] = Parameter(name, **kwargs)
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                if hasattr(param, k):
                    setattr(param, k, v)
                continue
            if k == "shape":
                if v is not None:
                    param.shape = v
                continue
            if k == "init" and v is None:
                continue
            if k == "dtype" and v is not None:
                v = dtype_name(v)
            if v is not None and v != existing:
                raise AssertionError(
                    f"Cannot retrieve Parameter '{name}' because desired "
                    f"attribute does not match with stored for attribute "
                    f"'{k}': desired '{v}' vs stored '{existing}'")
        return param

    def get_constant(self, name, value=None):
        """Get-or-create the :class:`Constant` ``prefix + name``."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError(
                    f"No constant named '{name}'. Please specify value "
                    "if you want to create a new constant.")
            param = self._params[name] = Constant(name, value)
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(
                    f"Cannot update self with other because they have "
                    f"different Parameters with the same name '{k}'")
            self._params[k] = v

    def initialize(self, init=None, device=None, generator=None,
                   force_reinit=False, ctx=None, verbose=False):
        """Initialize every parameter on ``device`` (or ``ctx``): ``init``
        is the default for those without their own initializer."""
        for v in self._params.values():
            v.initialize(None, device, init, generator=generator,
                         force_reinit=force_reinit, ctx=ctx)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def list_ctx(self):
        devices = set()
        for v in self.values():
            devices.update(v.list_ctx())
        return sorted(devices, key=repr)

    def setattr(self, name, value):
        """Set attribute ``name`` of every parameter (``grad_req``,
        ``lr_mult`` ...)."""
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        """``nd.save`` every parameter under its full name, less
        ``strip_prefix``."""
        from ..ndarray import save as nd_save
        arg = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    f"Prefix '{strip_prefix}' is to be stripped before "
                    f"saving, but Parameter's name '{param.name}' does not "
                    f"start with '{strip_prefix}'")
            arg[param.name[len(strip_prefix):]] = param.data().detach()
        nd_save(filename, arg)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix="", cast_dtype=False,
             dtype_source="current"):
        """Load a file of :meth:`save` (names prefixed with
        ``restore_prefix``; an ``arg:``/``aux:`` tag is dropped); a
        parameter without data yet is made on ``ctx`` (default: the
        card). Loaded values take each parameter's dtype."""
        from ..ndarray import load_tensors
        loaded = load_tensors(filename)
        arg_dict = {restore_prefix + k.split(":", 1)[-1]: v
                    for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise AssertionError(f"Parameter '{name}' is missing in "
                                         f"file '{filename}'")
        for name, v in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise ValueError(
                        f"Parameter '{name}' loaded from file "
                        f"'{filename}' is not present in this ParameterDict")
                continue
            self._params[name]._load(v, ctx)

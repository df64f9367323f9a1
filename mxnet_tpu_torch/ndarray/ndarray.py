"""NDArray: the imperative array of the port (mirrors
``mxnet_tpu/ndarray/ndarray.py``), a facade over one ``torch.Tensor``.

The class holds the tensor in ``_data``; every computing method goes
through :func:`~mxnet_tpu_torch.ops.invoke.apply_op` under the
reference's op name, so the AMP casts, the recording flags and the
random draws apply as they do to ``nd.*``. The methods keep the
reference's meanings where they differ from torch's: ``size`` is the
element count, ``dtype`` a numpy dtype (``torch.bfloat16`` for bfloat16,
which numpy cannot name), ``reshape`` takes the special codes 0, -1, -2,
-3, -4, ``transpose(*axes)``, ``repeat`` is numpy's, ``split`` takes a
number of outputs, ``max``/``min`` reduce.

It is a facade and not a ``torch.Tensor`` subclass: those methods mean
something else in torch, and a subclass reaching torch's or the port's
own functions (which call ``x.size(0)``, ``x.transpose(0, 1)``) would
compute wrong results silently. Torch functions take an NDArray anyway:
:meth:`NDArray.__torch_function__` unwraps it and returns what torch
returns (plain tensors). Only ``nd.*`` and the NDArray methods return
NDArrays; the port's modules keep tensors, and the entry points a user
hands arrays to (a gluon block's call, ``Trainer``, ``nd.save``, the
servers' ``submit``) unwrap them once.

``attach_grad(grad_req)`` makes the array a leaf that autograd records
(``requires_grad``) and gives it a zeroed gradient; ``grad_req="write"``
replaces the gradient on each ``backward``, ``"add"`` accumulates
(:func:`mxnet_tpu_torch.autograd.backward`).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from .. import context as _context
from .._device import resolve_device
from ..jit import check_host_read
from ..base import torch_dtype
from ..ops.invoke import apply_op

__all__ = ["NDArray", "numpy_dtype", "unwrap"]


def numpy_dtype(dtype):
    """``dtype`` (a torch dtype) as a numpy dtype; bfloat16 stays
    ``torch.bfloat16``, which numpy cannot name."""
    if dtype == torch.bfloat16:
        return dtype
    return np.dtype(str(dtype).replace("torch.", ""))


def unwrap(x):
    """An NDArray's tensor (and likewise inside lists, tuples and dicts);
    anything else as it is."""
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(unwrap(v) for v in x)
    if isinstance(x, dict):
        return {k: unwrap(v) for k, v in x.items()}
    return x


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return NDArray(out)
    if isinstance(out, (tuple, list)):
        return tuple(_wrap(o) for o in out)
    return out


def _op(name, inputs, params=None):
    return _wrap(apply_op(name, inputs, params))


class NDArray:
    """An imperative n-dimensional array on one device (the card or the
    CPU), over a ``torch.Tensor``."""

    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")
    # numpy defers to us in mixed expressions
    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data))
        if dtype is not None:
            data = data.to(torch_dtype(dtype))
        if ctx is not None:
            data = data.to(resolve_device(ctx))
        self._data = data
        self._grad = None
        self._grad_req = "null"

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*unwrap(args), **unwrap(kwargs or {}))

    # ------------------------------------------------------------ basics --
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def size(self):
        return self._data.numel()

    @property
    def context(self):
        """The array's device as a :class:`~mxnet_tpu_torch.context.
        Context` (``cpu(0)``, ``gpu(i)``); the tensor's own device is
        ``_data.device``."""
        return _context.device(self._data.device)

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def T(self):
        return self.transpose()

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous.")
        return bool(self.asscalar())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __index__(self):
        v = self.asscalar()
        if isinstance(v, bool) or not isinstance(v, int):
            raise TypeError("only integer arrays can be used as an index")
        return v

    # ------------------------------------------------------- sync points --
    def asnumpy(self) -> np.ndarray:
        """A host copy (blocking); bfloat16 comes back as float32. Inside
        a compiled training step it raises ``jit.HostSyncError``."""
        check_host_read("NDArray.asnumpy")
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        check_host_read("NDArray.asscalar")
        return self._data.detach().reshape(()).item()

    def item(self):
        return self.asscalar()

    def tolist(self):
        return self.asnumpy().tolist()

    def wait_to_read(self):
        """Wait for the work that writes this array: a synchronize of the
        current stream of its device (nothing on the CPU)."""
        check_host_read("NDArray.wait_to_read")
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype else a

    # ------------------------------------------------------------ dtypes --
    def astype(self, dtype, copy=True):
        d = torch_dtype(dtype)
        if not copy and self._data.dtype == d:
            return self
        return _op("cast", [self], {"dtype": dtype})

    def cast(self, dtype):
        return self.astype(dtype)

    # ----------------------------------------------------------- copying --
    def copy(self):
        return NDArray(self._data.clone())

    def copyto(self, other):
        """Copy into an existing array (keeping its device and dtype) or
        to a device."""
        if isinstance(other, NDArray):
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        return NDArray(self._data.to(resolve_device(other), copy=True))

    def as_in_context(self, ctx):
        dev = resolve_device(ctx)
        if dev == self._data.device:
            return self
        return NDArray(self._data.to(dev))

    as_in_ctx = as_in_context

    def as_nd_ndarray(self):
        return self

    def detach(self):
        return NDArray(self._data.detach())

    # ----------------------------------------------------------- autograd --
    def attach_grad(self, grad_req: str = "write", stype=None):
        """Make this array a recorded leaf with a zeroed gradient
        (``grad_req`` ``"write"``: each backward replaces it; ``"add"``:
        accumulates; ``"null"``: none)."""
        self._data = self._data.detach().requires_grad_(grad_req != "null")
        self._grad = NDArray(torch.zeros_like(self._data))
        self._grad_req = grad_req
        autograd._register_leaf(self)

    @property
    def grad(self):
        return self._grad

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # ----------------------------------------------------------- indexing --
    @staticmethod
    def _key(key):
        if isinstance(key, NDArray):
            key = key._data
        elif isinstance(key, tuple):
            key = tuple(k._data if isinstance(k, NDArray) else k
                        for k in key)
        if isinstance(key, np.ndarray):
            key = torch.from_numpy(key)
        if isinstance(key, torch.Tensor) and key.is_floating_point():
            key = key.long()
        return key

    def __getitem__(self, key):
        return NDArray(self._data[self._key(key)])

    def __setitem__(self, key, value):
        value = unwrap(value)
        with torch.no_grad():
            if isinstance(value, torch.Tensor):
                value = value.to(device=self._data.device,
                                 dtype=self._data.dtype)
            elif isinstance(value, np.ndarray):
                value = torch.from_numpy(value).to(
                    device=self._data.device, dtype=self._data.dtype)
            self._data[self._key(key)] = value

    # ---------------------------------------------------------- arithmetic --
    def _binop(self, other, opname, scalar_op):
        if isinstance(other, (NDArray, torch.Tensor, np.ndarray)):
            if isinstance(other, np.ndarray):
                other = torch.from_numpy(other).to(self._data.device)
            return _op(opname, [self, other])
        return _op(scalar_op, [self], {"scalar": float(other)})

    def _rbinop(self, other, opname, scalar_op):
        if isinstance(other, (torch.Tensor, np.ndarray)):
            if isinstance(other, np.ndarray):
                other = torch.from_numpy(other).to(self._data.device)
            return _op(opname, [other, self])
        return _op(scalar_op, [self], {"scalar": float(other)})

    def __add__(self, o):
        return self._binop(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._rbinop(o, "broadcast_sub", "_rminus_scalar")

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._rbinop(o, "broadcast_div", "_rdiv_scalar")

    def __mod__(self, o):
        return self._binop(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._rbinop(o, "broadcast_mod", "_rmod_scalar")

    def __pow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        return self._rbinop(o, "broadcast_power", "_rpower_scalar")

    def __neg__(self):
        return _op("negative", [self])

    def __abs__(self):
        return _op("abs", [self])

    def __eq__(self, o):
        if o is None:
            return False
        return self._binop(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binop(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binop(o, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binop(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binop(o, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    __hash__ = object.__hash__

    def _inplace(self, result):
        # the reference rebinds the array to the result
        self._data = result._data
        return self

    def __iadd__(self, o):
        return self._inplace(self.__add__(o))

    def __isub__(self, o):
        return self._inplace(self.__sub__(o))

    def __imul__(self, o):
        return self._inplace(self.__mul__(o))

    def __itruediv__(self, o):
        return self._inplace(self.__truediv__(o))

    # --------------------------------------------------- method op mirrors --
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return _op("reshape", [self], {"shape": tuple(shape)})

    def reshape_like(self, other):
        return _op("reshape_like", [self, other])

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _op("transpose", [self], {"axes": axes or None})

    def swapaxes(self, dim1, dim2):
        return _op("swapaxes", [self], {"dim1": dim1, "dim2": dim2})

    def flatten(self):
        return _op("flatten", [self])

    def expand_dims(self, axis):
        return _op("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return _op("squeeze", [self], {"axis": axis})

    def broadcast_to(self, shape):
        return _op("broadcast_to", [self], {"shape": tuple(shape)})

    def broadcast_like(self, other):
        return _op("broadcast_like", [self, other])

    def tile(self, reps):
        return _op("tile", [self], {"reps": tuple(reps) if isinstance(
            reps, (tuple, list)) else (reps,)})

    def repeat(self, repeats, axis=None):
        return _op("repeat", [self], {"repeats": repeats, "axis": axis})

    def flip(self, axis):
        return _op("flip", [self], {"axis": axis})

    def clip(self, a_min=None, a_max=None):
        return _op("clip", [self], {"a_min": a_min, "a_max": a_max})

    def slice_axis(self, axis, begin, end):
        return _op("slice_axis", [self],
                   {"axis": axis, "begin": begin, "end": end})

    def take(self, indices, axis=0, mode="clip"):
        return _op("take", [self, indices], {"axis": axis, "mode": mode})

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        return _op("one_hot", [self], {"depth": depth, "on_value": on_value,
                                       "off_value": off_value,
                                       "dtype": dtype})

    def _reduce(self, opname, axis=None, keepdims=False):
        return _op(opname, [self], {"axis": axis, "keepdims": keepdims})

    def sum(self, axis=None, keepdims=False):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._reduce("prod", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return _op("norm", [self], {"ord": ord, "axis": axis,
                                    "keepdims": keepdims})

    def argmax(self, axis=None, keepdims=False):
        return self._reduce("argmax", axis, keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._reduce("argmin", axis, keepdims)

    def argsort(self, axis=-1, is_ascend=True):
        return _op("argsort", [self], {"axis": axis, "is_ascend": is_ascend})

    def sort(self, axis=-1, is_ascend=True):
        return _op("sort", [self], {"axis": axis, "is_ascend": is_ascend})

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return _op("topk", [self], {"axis": axis, "k": k,
                                    "ret_typ": ret_typ,
                                    "is_ascend": is_ascend})

    def dot(self, other, transpose_a=False, transpose_b=False):
        return _op("dot", [self, other], {"transpose_a": transpose_a,
                                          "transpose_b": transpose_b})

    def abs(self):
        return _op("abs", [self])

    def sqrt(self):
        return _op("sqrt", [self])

    def square(self):
        return _op("square", [self])

    def exp(self):
        return _op("exp", [self])

    def log(self):
        return _op("log", [self])

    def relu(self):
        return _op("relu", [self])

    def sigmoid(self):
        return _op("sigmoid", [self])

    def tanh(self):
        return _op("tanh", [self])

    def softmax(self, axis=-1):
        return _op("softmax", [self], {"axis": axis})

    def log_softmax(self, axis=-1):
        return _op("log_softmax", [self], {"axis": axis})

    def zeros_like(self):
        return _op("zeros_like", [self])

    def ones_like(self):
        return _op("ones_like", [self])

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _op("split", [self], {"num_outputs": num_outputs,
                                     "axis": axis,
                                     "squeeze_axis": squeeze_axis})

    def pad(self, mode, pad_width, constant_value=0):
        return _op("pad", [self], {"mode": mode,
                                   "pad_width": tuple(pad_width),
                                   "constant_value": constant_value})

    # --------------------------------------------------------------- misc --
    def __dlpack__(self, *args, **kwargs):
        """DLPack export of the tensor (``torch.from_dlpack(x)`` is it,
        without a copy and off the autograd tape)."""
        return self._data.detach().__dlpack__(*args, **kwargs)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()

    def to_dlpack_for_read(self):
        return self.__dlpack__()

    to_dlpack_for_write = to_dlpack_for_read

    def __reduce__(self):
        # pickling goes through the host (the reference's save/load
        # lands on the default device too)
        return (NDArray, (self.asnumpy(),))

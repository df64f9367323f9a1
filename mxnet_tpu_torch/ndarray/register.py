"""Generation of the ``nd.*`` op namespace from the registry (the port of
``mxnet_tpu/ndarray/register.py``).

A generated function takes NDArrays, tensors or numpy arrays (numpy
arrays go to the device of the call's first array, else to the card),
calls :func:`~mxnet_tpu_torch.ops.invoke.apply_op` and returns NDArrays
(:class:`~.ndarray.NDArray`). A ``mutates`` op returns the arrays it
wrote, as given (tensors stay tensors); ``out=`` returns the ``out``
arrays, as given.

Positional arguments follow the reference convention: leading positional
arrays are the op's inputs (a variadic op takes them, or one list of
them, as its list); any further positionals map onto the impl's
parameters in declaration order (``nd.dot(a, b, True)`` sets
``transpose_a=True``).
"""
from __future__ import annotations

import inspect

import numpy as np
import torch

from .._device import resolve_device
from ..ops.invoke import apply_op
from ..ops.registry import _REGISTRY, Operator
from .ndarray import NDArray, _wrap

__all__ = ["make_op_func", "populate"]

_INTERNAL_PARAMS = ("rng", "_training", "out")


def _array_like(x):
    return isinstance(x, (NDArray, torch.Tensor, np.ndarray))


def _sig_params(op: Operator):
    """Every named parameter of the impl in declaration order (excluding
    *args/**kw and internals), and the count of positional-or-keyword
    names among them. Returns ``(names, n_positional)``."""
    try:
        sig = inspect.signature(op.impl)
    except (TypeError, ValueError):
        return [], 0
    names = [p.name for p in sig.parameters.values()
             if p.kind in (inspect.Parameter.KEYWORD_ONLY,
                           inspect.Parameter.POSITIONAL_OR_KEYWORD)
             and p.name not in _INTERNAL_PARAMS]
    n_pos = sum(1 for p in sig.parameters.values()
                if p.kind == inspect.Parameter.POSITIONAL_OR_KEYWORD
                and p.name not in _INTERNAL_PARAMS)
    return names, n_pos


def _as_inputs(arrays):
    """NDArrays and tensors stay as they are; numpy arrays go to the
    device of the first NDArray or tensor among ``arrays``, or to the
    card."""
    dev = next((a._data.device if isinstance(a, NDArray) else a.device
                for a in arrays if isinstance(a, (NDArray, torch.Tensor))),
               None)
    if dev is None and any(isinstance(a, np.ndarray) for a in arrays):
        dev = resolve_device()
    return [torch.from_numpy(np.array(a)).to(dev)
            if isinstance(a, np.ndarray) else a for a in arrays]


def make_op_func(op: Operator):
    pnames, n_pos = _sig_params(op)

    def fn(*args, out=None, **kwargs):
        i = 0
        if op.variadic and args and isinstance(args[0], (list, tuple)):
            arrays = list(args[0])
            i = 1
        else:
            while i < len(args) and _array_like(args[i]):
                i += 1
            arrays = list(args[:i])
        params = dict(kwargs)
        # remaining positionals fill the impl's parameters after the ones
        # the arrays bind: one each for plain signatures, the list
        # parameter for variadic ops, none for *args impls
        skip = 1 if op.variadic else min(len(arrays), n_pos)
        for v, name in zip(args[i:], pnames[skip:]):
            params.setdefault(name, v)
        params.pop("name", None)  # symbol-compat kwarg, ignored eagerly
        inputs = _as_inputs(arrays)
        res = apply_op(op, inputs, params, out=out)
        if out is not None:
            return out
        if op.mutates:
            # the written arrays as given (a numpy input's copy wrapped)
            res = res if isinstance(res, tuple) else (res,)
            picked = tuple(
                arrays[m] if isinstance(arrays[m], (NDArray, torch.Tensor))
                else NDArray(r) for m, r in zip(op.mutates, res))
            return picked[0] if len(picked) == 1 else picked
        return _wrap(res)

    fn.__name__ = op.name
    fn.__qualname__ = op.name
    fn.__doc__ = op.doc or f"Generated wrapper for op {op.name!r}."
    return fn


def populate(namespace: dict, filter_fn=None):
    """Set a generated function for every registered op into
    ``namespace`` (names already there are kept)."""
    for name, op in _REGISTRY.items():
        if filter_fn and not filter_fn(name):
            continue
        namespace.setdefault(name, make_op_func(op))

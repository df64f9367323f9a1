"""Generation of the ``nd.*`` op namespace from the registry (the port of
``mxnet_tpu/ndarray/register.py``).

The port's NDArray is ``torch.Tensor``, as in its gluon: an array input
is a tensor or a numpy array (moved to the device of the call's first
tensor, else to the card), and ops return tensors. The MXNet-only
methods of the JAX package's NDArray class (``asnumpy``,
``attach_grad``, ``wait_to_read``, ...) wait for the framework-core item
of ROADMAP.md.

Positional arguments follow the reference convention: leading positional
arrays are the op's inputs; any further positionals map onto the impl's
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

__all__ = ["make_op_func", "populate"]

_INTERNAL_PARAMS = ("rng", "_training")


def _array_like(x):
    return isinstance(x, (torch.Tensor, np.ndarray))


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


def _as_tensors(arrays):
    """Tensors stay as they are; numpy arrays go to the device of the
    first tensor among ``arrays``, or to the card."""
    dev = next((a.device for a in arrays if isinstance(a, torch.Tensor)),
               None)
    if dev is None and arrays:
        dev = resolve_device()
    return [a if isinstance(a, torch.Tensor)
            else torch.from_numpy(np.array(a)).to(dev) for a in arrays]


def make_op_func(op: Operator):
    pnames, n_pos = _sig_params(op)

    def fn(*args, out=None, **kwargs):
        i = 0
        while i < len(args) and _array_like(args[i]):
            i += 1
        arrays = list(args[:i])
        params = dict(kwargs)
        # remaining positionals fill the impl's parameters after the ones
        # the arrays bind: one each for plain signatures, none for *args
        # impls (variadic ops are not ported: apply_op refuses them)
        skip = min(len(arrays), n_pos)
        for v, name in zip(args[i:], pnames[skip:]):
            params.setdefault(name, v)
        params.pop("name", None)  # symbol-compat kwarg, ignored eagerly
        return apply_op(op, _as_tensors(arrays), params, out=out)

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

"""Reduction ops (the port of ``mxnet_tpu/ops/reduce.py``).

The reference's semantics kept: ``exclude=True`` reduces over every axis
NOT listed; ``argmax``/``argmin``/``argmax_channel`` return float32
indices; a sum or product of integers keeps their dtype (torch would
widen it to int64); an empty axis tuple reduces nothing.
"""
from __future__ import annotations

import torch

from .registry import _REGISTRY, Operator, alias


def _reg(name, fn, differentiable=True, nout=1):
    _REGISTRY[name] = Operator(name, fn, nout=nout,
                               differentiable=differentiable)


def _axes(axis, ndim, exclude=False):
    """The reference's axis spec as a tuple of non-negative axes (None:
    every axis)."""
    if axis is None:
        return None
    if isinstance(axis, int):
        axis = (axis,)
    axis = tuple(a % ndim for a in axis)
    if exclude:
        axis = tuple(a for a in range(ndim) if a not in axis)
    return axis


def _dims(ax, x):
    return tuple(range(x.ndim)) if ax is None else ax


def _int_dtype(x):
    """The accumulation dtype of an integer (or boolean) input: its own
    (int32 for booleans), as the JAX package's; None for floats."""
    if x.is_floating_point() or x.is_complex():
        return None
    return torch.int32 if x.dtype == torch.bool else x.dtype


def _sum(x, ax, keepdims):
    if ax == ():
        return x
    return torch.sum(x, dim=_dims(ax, x), keepdim=keepdims,
                     dtype=_int_dtype(x))


def _mean(x, ax, keepdims):
    if ax == ():
        return x if x.is_floating_point() else x.float()
    if not x.is_floating_point():
        x = x.float()
    return torch.mean(x, dim=_dims(ax, x), keepdim=keepdims)


def _prod_all(x, ax, keepdims):
    """Product over ``ax`` (torch's ``prod`` takes one axis at a time)."""
    dims = sorted(_dims(ax, x), reverse=True)
    for d in dims:
        x = torch.prod(x, dim=d, keepdim=keepdims, dtype=_int_dtype(x))
    return x


def _max(x, ax, keepdims):
    if ax == ():
        return x
    return torch.amax(x, dim=_dims(ax, x), keepdim=keepdims)


def _min(x, ax, keepdims):
    if ax == ():
        return x
    return torch.amin(x, dim=_dims(ax, x), keepdim=keepdims)


def _nansum(x, ax, keepdims):
    return _sum(torch.where(torch.isnan(x), torch.zeros_like(x), x), ax,
                keepdims)


def _nanprod(x, ax, keepdims):
    return _prod_all(torch.where(torch.isnan(x), torch.ones_like(x), x), ax,
                     keepdims)


def _make_reduce(fn):
    def impl(x, axis=None, keepdims=False, exclude=False):
        return fn(x, _axes(axis, x.ndim, exclude), keepdims)
    return impl


for _n, _f in {"sum": _sum, "mean": _mean, "prod": _prod_all, "max": _max,
               "min": _min, "nansum": _nansum, "nanprod": _nanprod}.items():
    _reg(_n, _make_reduce(_f))

alias("sum_axis", "sum")
alias("max_axis", "max")
alias("min_axis", "min")


def _norm(x, ord=2, axis=None, keepdims=False):
    ax = _axes(axis, x.ndim)
    if ord == 1:
        return _sum(x.abs(), ax, keepdims)
    return torch.sqrt(_sum(torch.square(x), ax, keepdims))


_reg("norm", _norm)


def _make_argreduce(fn):
    def impl(x, axis=None, keepdims=False):
        if axis is None:
            out = fn(x.reshape(-1), dim=0)
            if keepdims:
                out = out.reshape((1,) * x.ndim)
        else:
            out = fn(x, dim=axis, keepdim=keepdims)
        return out.to(torch.float32)
    return impl


_reg("argmax", _make_argreduce(torch.argmax), differentiable=False)
_reg("argmin", _make_argreduce(torch.argmin), differentiable=False)
_reg("argmax_channel", lambda x: torch.argmax(x, dim=1).to(torch.float32),
     differentiable=False)


def _moments(x, axes=None, keepdims=False):
    ax = _axes(axes, x.ndim)
    mean = _mean(x, ax, keepdims)
    var = _mean(torch.square(x - _mean(x, ax, True)), ax, keepdims)
    return mean, var


_reg("moments", _moments, nout=2)


def _cumsum(x, axis=None, dtype=None):
    if dtype is not None:
        from ..base import torch_dtype
        x = x.to(torch_dtype(dtype))
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, dim=axis, dtype=_int_dtype(x))


_reg("cumsum", _cumsum)


def _logsumexp(x, axis=None, keepdims=False):
    ax = _axes(axis, x.ndim)
    m = _max(x, ax, True)
    return torch.log(_sum(torch.exp(x - m), ax, keepdims)) \
        + _max(x, ax, keepdims)


_reg("logsumexp", _logsumexp)

"""Operator registry (the port of ``mxnet_tpu/ops/registry.py``).

Each op is one PyTorch function; the registry keys the generated ``nd``
namespace (:mod:`mxnet_tpu_torch.ndarray.register`) as the reference's
NNVM registry keys MXNet's generated Python op functions. Autograd is
torch's own: an op is differentiable when its function is, and a
non-differentiable op runs under ``torch.no_grad()``
(:func:`mxnet_tpu_torch.ops.invoke.apply_op`).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

__all__ = ["Operator", "register", "get", "list_ops", "alias"]


class Operator:
    """A registered op.

    Attributes
    ----------
    name : canonical op name (the JAX package's name)
    impl : function ``impl(*tensors, **params) -> tensor | tuple``
    nout : number of outputs (int); tuple outputs must match
    differentiable : if False the op never lands on the autograd tape
    variadic : if True the wrapper collects leading positional arrays into
        a single list argument
    mutates : indices of the inputs the op updates in place
    needs_rng, needs_train : the op takes a random key / the training flag
    host_op : the op runs a host callback
    """

    __slots__ = ("name", "impl", "nout", "differentiable", "variadic",
                 "mutates", "needs_rng", "needs_train", "host_op", "doc")

    def __init__(self, name: str, impl: Callable, nout: int = 1,
                 differentiable: bool = True, variadic: bool = False,
                 mutates: Optional[Sequence[int]] = None,
                 needs_rng: bool = False, needs_train: bool = False,
                 host_op: bool = False):
        self.name = name
        self.impl = impl
        self.nout = nout
        self.differentiable = differentiable
        self.variadic = variadic
        self.mutates = tuple(mutates) if mutates else ()
        self.needs_rng = needs_rng
        self.needs_train = needs_train
        self.host_op = host_op
        self.doc = impl.__doc__

    def __repr__(self):
        return f"<Operator {self.name}>"


_REGISTRY: Dict[str, Operator] = {}


def register(name: Optional[str] = None, nout: int = 1,
             differentiable: bool = True, variadic: bool = False,
             mutates: Optional[Sequence[int]] = None,
             needs_rng: bool = False, needs_train: bool = False):
    """Decorator registering a PyTorch function as a framework op."""

    def deco(fn: Callable) -> Callable:
        opname = name or fn.__name__
        if opname in _REGISTRY:
            raise ValueError(f"op {opname!r} already registered")
        _REGISTRY[opname] = Operator(opname, fn, nout=nout,
                                     differentiable=differentiable,
                                     variadic=variadic, mutates=mutates,
                                     needs_rng=needs_rng,
                                     needs_train=needs_train)
        return fn

    return deco


def alias(new: str, existing: str):
    """Register an alias name for an existing op."""
    op = _REGISTRY[existing]
    if new not in _REGISTRY:
        _REGISTRY[new] = op


def get(name: str) -> Operator:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"operator {name!r} is not registered; see "
                       f"mxnet_tpu_torch.ops") from None


def list_ops():
    return sorted(_REGISTRY)

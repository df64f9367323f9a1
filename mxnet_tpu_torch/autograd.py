"""Autograd of the port (mirrors ``mxnet_tpu/autograd.py``).

``record()``, ``pause()``, ``train_mode()`` and ``predict_mode()`` keep
MXNet's two thread-local flags: *recording* (``record()`` turns torch's
gradient mode on, ``pause()`` turns it off) and *training* (read by
layers such as ``Dropout``, which is active only under ``record()`` or
``train_mode()``); ``set_recording``/``set_training`` set them. The tape
is torch's own: a recorded op's result carries its ``grad_fn``.

:func:`backward` and :func:`grad` take NDArrays or tensors.
``backward`` writes each attached variable's gradient
(``NDArray.attach_grad``, :func:`mark_variables`) by its ``grad_req``:
``"write"`` replaces it, ``"add"`` accumulates. A gluon parameter's
``grad_req`` is kept by :mod:`mxnet_tpu_torch.gluon.parameter`.
``grad(..., create_graph=True)`` records the gradient computation, so
its result can be differentiated again.

A sparse-gradient lookup (``Embedding(sparse_grad=True)``) gives its
weight a hybrid COO gradient; ``backward`` and ``grad`` hand it on as an
``nd.sparse.RowSparseNDArray`` (its ids as they stand, uncoalesced).
Two such gradients of one variable concatenate (torch's accumulation);
a sparse and a dense one sum densely, and so does ``grad_req="add"``
into the dense zeros ``attach_grad`` starts from, as in the reference.
"""
from __future__ import annotations

import threading
import weakref

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "get_symbol"]


class _AGState(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _AGState()


class _Scope:
    def __init__(self, recording, training):
        self._rec, self._train = recording, training
        self._grad = None

    def __enter__(self):
        self._old = (_STATE.recording, _STATE.training)
        if self._rec is not None:
            _STATE.recording = self._rec
            self._grad = torch.enable_grad() if self._rec else \
                torch.no_grad()
            self._grad.__enter__()
        if self._train is not None:
            _STATE.training = self._train
        return self

    def __exit__(self, *exc):
        if self._grad is not None:
            self._grad.__exit__(*exc)
            self._grad = None
        _STATE.recording, _STATE.training = self._old
        return False


def record(train_mode=True):
    """Scope whose operations are recorded for ``backward()``."""
    return _Scope(True, train_mode)


def pause(train_mode=False):
    """Scope whose operations are not recorded."""
    return _Scope(False, train_mode)


def train_mode():
    return _Scope(None, True)


def predict_mode():
    return _Scope(None, False)


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training


def set_recording(is_record):
    """Set the recording flag (and torch's gradient mode with it);
    returns the previous flag."""
    prev, _STATE.recording = _STATE.recording, bool(is_record)
    torch.set_grad_enabled(bool(is_record))
    return prev


def set_training(train):
    """Set the training flag; returns the previous one."""
    prev, _STATE.training = _STATE.training, bool(train)
    return prev


# the NDArrays given a gradient (attach_grad, mark_variables), by id:
# process-wide, since attach_grad may run on one thread and backward on
# another; entries die with their arrays
_LEAVES = weakref.WeakValueDictionary()


def _register_leaf(array):
    _LEAVES[id(array)] = array


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to arrays: each variable becomes a
    recorded leaf whose gradient is written into (or added to) the given
    buffer."""
    if not isinstance(variables, (list, tuple)):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v.attach_grad(grad_req=req)
        if g is not None:
            v._grad = g


def _tensor(x):
    return getattr(x, "_data", x)


def _heads(heads, head_grads):
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    hs = [_tensor(h) for h in heads]
    for h in hs:
        if h.grad_fn is None and not h.requires_grad:
            raise ValueError(
                "cannot differentiate a head that was not computed inside "
                "autograd.record()")
    if head_grads is None:
        gs = [None] * len(hs)
    else:
        gs = [None if g is None else _tensor(g) for g in head_grads]
    gs = [torch.ones_like(h) if g is None else g for h, g in zip(hs, gs)]
    return hs, gs


def _as_array(g):
    """A gradient tensor as an NDArray (a sparse one as a
    RowSparseNDArray)."""
    from .ndarray.ndarray import NDArray
    if g.is_sparse:
        from .ndarray.sparse import RowSparseNDArray
        return RowSparseNDArray.from_coo(g)
    return NDArray(g)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to every attached variable,
    stored in each variable's ``.grad`` by its ``grad_req``."""
    from .ndarray.sparse import add as _sparse_add, RowSparseNDArray
    hs, gs = _heads(heads, head_grads)
    leaves = [a for a in list(_LEAVES.values())
              if a._grad_req != "null" and a._data.requires_grad]
    for a in leaves:
        a._data.grad = None
    with _Scope(None, train_mode):
        torch.autograd.backward(hs, gs, retain_graph=retain_graph)
    for a in leaves:
        g = a._data.grad
        if g is None:
            continue
        a._data.grad = None
        # a new gradient array each time, as the JAX package's
        g = _as_array(g)
        if a._grad_req == "add" and a._grad is not None:
            if isinstance(a._grad, RowSparseNDArray) and \
                    isinstance(g, RowSparseNDArray):
                g = _sparse_add(a._grad, g)
            else:
                g = _as_array(a._grad._data + g._data)
        a._grad = g


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables``, without
    touching their ``.grad``; a variable the heads do not depend on gets
    zeros. With ``create_graph`` the gradients are themselves recorded
    (and the graph kept unless ``retain_graph=False``)."""
    from .ndarray.ndarray import NDArray
    single = not isinstance(variables, (list, tuple))
    vars_ = [variables] if single else list(variables)
    if retain_graph is None:
        retain_graph = create_graph
    hs, gs = _heads(heads, head_grads)
    xs = [_tensor(v) for v in vars_]
    with _Scope(True if create_graph else None, train_mode):
        got = torch.autograd.grad(hs, xs, gs, retain_graph=retain_graph,
                                  create_graph=create_graph,
                                  allow_unused=True)
    out = [NDArray(torch.zeros_like(x)) if g is None else _as_array(g)
           for g, x in zip(got, xs)]
    return out[0] if single else out


def get_symbol(x):
    """Not available: the port keeps no symbolic graph of a recording
    (the reference's answer too)."""
    raise NotImplementedError("autograd.get_symbol is not supported: no "
                              "symbolic graph is kept; use the Symbol API")

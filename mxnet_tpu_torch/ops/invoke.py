"""Eager op invocation (the port of ``mxnet_tpu/ops/invoke.py``
``apply_op``).

:func:`apply_op` is the one chokepoint every generated ``nd.*`` function
and every computing :class:`~mxnet_tpu_torch.ndarray.NDArray` method goes
through. It unwraps NDArray inputs to their tensors and calls
``op.impl(*tensors, **params)`` (a ``variadic`` op: ``impl(list(tensors),
**params)``); a non-differentiable op runs under ``torch.no_grad()``, so
it never lands on the autograd tape; ``out=`` copies the results into
the given tensors, untaped (an impl marked ``writes_out``, the update
tail's, takes the targets itself). It returns tensors: ``nd.*`` and the
NDArray methods wrap them. Autograd itself is torch's (recording is
:mod:`mxnet_tpu_torch.autograd`'s scopes).

The registry's invocation features, as the reference's chokepoint has
them:

- ``needs_rng``: the op gets ``rng=``, the generator of the next draw of
  :mod:`mxnet_tpu_torch._rng` on the op's device (its first tensor's,
  else its ``ctx``, else the card), unless the caller passed one;
- ``needs_train``: the op gets ``_training=autograd.is_training()``;
- ``host_op`` (an op whose output shape depends on its data): runs
  eagerly, a torch tensor's host round trip built in; inside a CUDA-graph
  capture it raises and names the op rather than synchronise.

Under :func:`mxnet_tpu_torch.amp.init` the chokepoint casts each
op's tensor inputs by its name (:func:`_amp_cast_inputs`, the
reference's rule): an op in the low-precision list gets its f32 inputs
in the target dtype, one in the f32 list its target-dtype inputs in
f32; anything else passes through. Gluon layers call the functions of
:mod:`.nn` (and the attention op) directly, not through
:func:`apply_op`, so those functions apply the same cast under their
registered names (:func:`amp_cast`). The cast is ``Tensor.to``, which
autograd differentiates: f32 master weights get f32 gradients.

A ``mutates`` op (the optimizer updates of :mod:`.optimizer_ops`)
writes its results into the inputs it names, in place: the port's
weights and states stay where they are, so there is nothing to donate.
While ``optimizer.fused`` records a step, :data:`_FUSED_RECORDER` holds
its recorder and a mutates op (single or variadic) is handed to it
instead of running (the reference's chokepoint hook,
``mxnet_tpu/ops/invoke.py:202-250``).

Under ``autograd.record()``, ``Embedding(sparse_grad=True)`` and
``_contrib_SparseEmbedding`` run :class:`_SparseEmbedding`, whose
backward gives the weight a row-sparse gradient (the reference's
``_embedding_sparse_grad``): a hybrid COO tensor of the looked-up ids in
lookup order and the output's cotangent rows, not coalesced, with no
(vocab, dim) scatter. ``Parameter.grad()`` and ``autograd.backward`` hand
it on as an ``nd.sparse.RowSparseNDArray``. Inside a CUDA-graph capture
the lookup takes the dense gradient, as the reference's does under
tracing. Two lookups of one weight in one backward are accumulated by
torch's engine: the port's gradient lists their ids lookup by lookup in
forward order, the reference's in reverse order (the rows they sum to
are the same).
"""
from __future__ import annotations

import functools
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from .. import _rng, autograd
from .._device import resolve_device
from .registry import Operator, get as get_op

__all__ = ["apply_op", "amp_cast", "as_tensor", "TRACED_HYPERPARAMS"]

# Per-step hyperparameters of the update ops: a recorded step keeps them
# out of its signature, so an lr/wd/momentum schedule or a loss scale
# change reuses the recorded program (optimizer/fused.py). Other kwargs
# (clip bounds, betas, epsilon) are part of the signature.
TRACED_HYPERPARAMS = frozenset({"lr", "wd", "momentum", "rescale_grad"})

# Set by optimizer.fused while it records an update step: apply_op hands
# each mutates-op call to the recorder instead of running it.
_FUSED_RECORDER = threading.local()


def _is_dynamic(v):
    """A hyperparameter that is itself a tensor (a device value the
    host cannot read without a sync)."""
    return isinstance(v, torch.Tensor)


def _split_hyper(params):
    """(static kwargs, per-step keys, per-step values) of one
    mutates-op call: plain floats under :data:`TRACED_HYPERPARAMS` are
    per-step; everything else (bools, ints, None, the other floats) is
    static and keys the recorded program."""
    static, tkeys, tvals = [], [], []
    for k in sorted(params):
        v = params[k]
        if k in TRACED_HYPERPARAMS and isinstance(v, (float, np.floating)) \
                and not isinstance(v, bool):
            tkeys.append(k)
            tvals.append(float(v))
        else:
            static.append((k, v))
    return tuple(static), tuple(tkeys), tvals

# AMP state, set by mxnet_tpu_torch.amp.init / uninit (the reference's
# mxnet_tpu/ops/invoke.py _AMP): the target dtype and the op-name lists
_AMP = {"active": False, "dtype": None, "lp_ops": frozenset(),
        "f32_ops": frozenset()}


def _amp_cast_inputs(op_name, inputs):
    """``inputs`` with each float32 or target-dtype tensor cast to the
    dtype op ``op_name`` runs in under AMP (the target for a
    low-precision op, f32 for an f32 op); other inputs, and every input
    of an op in neither list, pass through."""
    if op_name in _AMP["lp_ops"]:
        target = _AMP["dtype"]
    elif op_name in _AMP["f32_ops"]:
        target = torch.float32
    else:
        return inputs
    return [x.to(target) if isinstance(x, torch.Tensor)
            and x.dtype in (torch.float32, _AMP["dtype"]) else x
            for x in inputs]


def amp_cast(op_name):
    """Decorator: the function's positional tensor inputs take the AMP
    cast of op ``op_name`` while AMP is on (a no-op otherwise)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if _AMP["active"]:
                args = _amp_cast_inputs(op_name, args)
            return fn(*args, **kwargs)
        return wrapped
    return deco


def _ndarray_cls():
    from ..ndarray.ndarray import NDArray
    return NDArray


def as_tensor(x):
    """An NDArray's tensor; anything else as it is."""
    return x._data if isinstance(x, _ndarray_cls()) else x


def _draw_device(inputs, params):
    """The device a random op draws on: its first tensor input's, else
    its ``ctx`` parameter, else the card."""
    for x in inputs:
        if isinstance(x, torch.Tensor):
            return x.device
    ctx = params.get("ctx")
    return resolve_device(ctx)


class _SparseEmbedding(torch.autograd.Function):
    """Rows of ``weight`` at ``ids``; the weight's gradient is a hybrid
    COO tensor (sparse dim 1) of ``ids`` in lookup order and the
    cotangent's rows, uncoalesced."""

    @staticmethod
    def forward(ctx, ids, weight):
        idx = ids.long()
        ctx.save_for_backward(idx)
        ctx.wshape = tuple(weight.shape)
        return torch.nn.functional.embedding(idx, weight)

    @staticmethod
    def backward(ctx, dy):
        (idx,) = ctx.saved_tensors
        n, d = ctx.wshape
        gw = torch.sparse_coo_tensor(idx.reshape(1, -1), dy.reshape(-1, d),
                                     (n, d), check_invariants=False)
        return None, gw


def _capturing():
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _call(op, inputs, params):
    if op.variadic:
        return op.impl(list(inputs), **params)
    return op.impl(*inputs, **params)


def apply_op(op, inputs: Sequence, params: Optional[dict] = None,
             out=None):
    """Invoke a registered op (or its name) on tensor or NDArray inputs;
    returns tensors."""
    if not isinstance(op, Operator):
        op = get_op(op)
    params = dict(params) if params else {}
    NDArray = _ndarray_cls()
    inputs = [as_tensor(x) for x in inputs]
    if _AMP["active"]:
        inputs = _amp_cast_inputs(op.name, inputs)
    if op.needs_rng and params.get("rng") is None:
        params["rng"] = _rng.next_generator(_draw_device(inputs, params))
    if op.needs_train and "_training" not in params:
        params["_training"] = autograd.is_training()
    if op.mutates:
        recorder = getattr(_FUSED_RECORDER, "rec", None)
        if recorder is not None:
            return recorder.record(op, inputs, params)
        with torch.no_grad():
            outs = _call(op, inputs, params)
            outs_t = (outs,) if not isinstance(outs, (tuple, list)) \
                else tuple(outs)
            results = []
            for o, m in zip(outs_t, op.mutates):
                if o is not inputs[m]:
                    inputs[m].copy_(o)
                results.append(inputs[m])
        return results[0] if len(results) == 1 else tuple(results)
    if op.host_op and torch.cuda.is_available() \
            and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"op {op.name!r} reads its data on the host to size its output "
            "(host_op) and cannot run inside a CUDA-graph capture")
    if ((op.name == "Embedding" and params.get("sparse_grad"))
            or op.name == "_contrib_SparseEmbedding") \
            and autograd.is_recording() and out is None \
            and inputs[1].requires_grad and torch.is_grad_enabled() \
            and not _capturing():
        return _SparseEmbedding.apply(inputs[0], inputs[1])
    if out is not None:
        single_out = isinstance(out, (torch.Tensor, NDArray))
        targets = (out,) if single_out else tuple(out)
        targets = tuple(as_tensor(t) for t in targets)
        if getattr(op.impl, "writes_out", False):
            # the op writes its targets itself (the update tail: in place
            # when they are its own inputs)
            with torch.no_grad():
                _call(op, inputs, dict(params, out=list(targets)))
            return targets[0] if single_out else targets
    if op.differentiable:
        outs = _call(op, inputs, params)
    else:
        with torch.no_grad():
            outs = _call(op, inputs, params)
    if out is None:
        return outs
    single = not isinstance(outs, (tuple, list))
    outs_t = (outs,) if single else tuple(outs)
    with torch.no_grad():
        for t, o in zip(targets, outs_t):
            t.copy_(o)
    return targets[0] if single else tuple(targets)

"""Eager op invocation (the port of ``mxnet_tpu/ops/invoke.py``
``apply_op``, the subset the ported ops need).

:func:`apply_op` is the one chokepoint every generated ``nd.*``
function goes through. It calls ``op.impl(*tensors, **params)``; a
non-differentiable op runs under ``torch.no_grad()``, so it never lands
on the autograd tape; ``out=`` copies the results into the given
tensors, untaped. Autograd itself is torch's (recording is
:mod:`mxnet_tpu_torch.autograd`'s scopes).

Not ported yet (ROADMAP.md, framework core): the AMP input casts (the
port has no AMP), in-place ``mutates`` ops, ``host_op`` rerouting, random
keys (``needs_rng``), the training flag (``needs_train``), list inputs
(``variadic``) and sparse Embedding gradients. An op that asks for one of
them raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import autograd
from .registry import Operator, get as get_op

__all__ = ["apply_op"]


def _unported(op, what):
    raise NotImplementedError(
        f"op {op.name!r} needs {what}, which the PyTorch port does not "
        f"have yet (ROADMAP.md, framework core)")


def apply_op(op, inputs: Sequence, params: Optional[dict] = None,
             out=None):
    """Invoke a registered op (or its name) on tensor inputs."""
    if not isinstance(op, Operator):
        op = get_op(op)
    params = dict(params) if params else {}
    if op.mutates:
        _unported(op, "in-place updates of its inputs (mutates)")
    if op.host_op:
        _unported(op, "host-callback rerouting (host_op)")
    if op.needs_rng:
        _unported(op, "a random key (needs_rng)")
    if op.needs_train:
        _unported(op, "the training flag (needs_train)")
    if op.variadic:
        _unported(op, "a list of inputs (variadic)")
    if ((op.name == "Embedding" and params.get("sparse_grad"))
            or op.name == "_contrib_SparseEmbedding") \
            and autograd.is_recording():
        _unported(op, "sparse embedding gradients")
    if op.differentiable:
        outs = op.impl(*inputs, **params)
    else:
        with torch.no_grad():
            outs = op.impl(*inputs, **params)
    if out is None:
        return outs
    single = not isinstance(outs, (tuple, list))
    outs_t = (outs,) if single else tuple(outs)
    targets = (out,) if isinstance(out, torch.Tensor) else tuple(out)
    with torch.no_grad():
        for t, o in zip(targets, outs_t):
            t.copy_(o)
    return targets[0] if single else tuple(targets)

"""Neural-network operators the training slice needs, as plain functions
on tensors (mirrors the ops of ``mxnet_tpu/ops/nn.py`` and ``shape_ops``
under their registered names).

``FullyConnected`` keeps MXNet's weight layout ``(units, in_units)``;
its product, and ``dot``'s, is ``torch.matmul``, as the JAX package
leaves it to XLA. Gluon layers call these through ``F`` in
``hybrid_forward``, not through the op chokepoint, so each function
applies the chokepoint's AMP cast under its registered name itself
(:func:`~.invoke.amp_cast`): under ``amp.init()`` ``FullyConnected``,
``Embedding`` and ``dot`` run in the target dtype, ``LayerNorm`` and
``log_softmax`` in f32.
"""
from __future__ import annotations

import torch

from .. import autograd
from .invoke import amp_cast

__all__ = ["FullyConnected", "LayerNorm", "Activation", "Embedding",
           "Dropout", "log_softmax", "pick", "dot"]


@amp_cast("FullyConnected")
def FullyConnected(x, weight, bias=None, flatten=True):
    """``dot(x, weight^T) + bias``; ``flatten=True`` first folds every
    axis after the first into one, ``flatten=False`` applies to the last
    axis."""
    if flatten and x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    out = torch.matmul(x, weight.t())
    return out if bias is None else out + bias


@amp_cast("LayerNorm")
def LayerNorm(x, gamma, beta, axis=-1, eps=1e-5):
    """Normalise over ``axis`` (biased variance), then scale and shift."""
    mean = x.mean(dim=axis, keepdim=True)
    var = (x - mean).square().mean(dim=axis, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    return out * gamma.reshape(shape) + beta.reshape(shape)


_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    # exact erf form, as jax.nn.gelu(approximate=False)
    "gelu": torch.nn.functional.gelu,
}


@amp_cast("Activation")
def Activation(x, act_type="relu"):
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise ValueError(f"unknown act_type {act_type}")
    return fn(x)


@amp_cast("Embedding")
def Embedding(data, weight):
    """Rows of ``weight`` at ``data``; indices may arrive as floats and
    are truncated to integers, as ``astype(int32)`` does. Under AMP float
    indices are cast to the target dtype first, as in the reference
    (ids above 256 then round in bf16): pass integer ids."""
    return torch.nn.functional.embedding(data.long(), weight)


@amp_cast("Dropout")
def Dropout(x, p=0.5, generator=None):
    """Inverted dropout, active only in training mode
    (``autograd.is_training()``). Draws from ``generator`` (default:
    torch's generator of ``x``'s device)."""
    if p == 0 or not autograd.is_training():
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


@amp_cast("log_softmax")
def log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


@amp_cast("pick")
def pick(x, index, axis=-1, keepdims=False):
    """``x`` at ``index`` along ``axis`` (indices clipped into range)."""
    ax = axis % x.ndim
    idx = index.long().clamp(0, x.shape[ax] - 1).unsqueeze(ax)
    out = torch.gather(x, ax, idx)
    return out if keepdims else out.squeeze(ax)


@amp_cast("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """The reference's ``dot``: the last axis of ``lhs`` contracted with
    the first of ``rhs``, each reversed first where its ``transpose_*``
    is set."""
    if transpose_a:
        lhs = lhs.permute(*reversed(range(lhs.ndim)))
    if transpose_b:
        rhs = rhs.permute(*reversed(range(rhs.ndim)))
    if lhs.ndim == 2 and rhs.ndim == 2:
        return torch.matmul(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=1)

"""``nd.random`` (and ``mx.random``): the sampling namespace (mirrors
``mxnet_tpu/ndarray/random.py``).

Scalar distribution parameters go to the ``_random_*`` ops, array
parameters to the ``_sample_*`` ops (one row of samples per parameter
element), as the reference dispatches (:func:`_dispatch`). Each call is
one draw of the process RNG (:mod:`mxnet_tpu_torch._rng`): ``seed``
restarts the stream, and a draw lands on ``ctx`` (default: the card), or
on its parameter arrays' device.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _rng
from .._device import resolve_device
from ..ops.invoke import apply_op
from .ndarray import NDArray, _wrap

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "randint", "shuffle", "seed", "bernoulli"]


def seed(seed_state, ctx="all"):
    """Seed the process RNG (every device: a draw's stream depends on
    its position, not on a device) and torch's default generator, which
    the initializers draw from when given none: a seed fixes the initial
    parameters, as in the reference."""
    _rng.seed(seed_state)
    torch.manual_seed(int(seed_state) & ((1 << 64) - 1))


def _ctx(ctx):
    return resolve_device(ctx)


def _draw(op, inputs, params, ctx, out):
    if not inputs:
        params = dict(params, ctx=_ctx(ctx))
    res = apply_op(op, inputs, params, out=out)
    return out if out is not None else _wrap(res)


def _dispatch(scalar_op, sample_op, scalar_params, arr_args, shape, dtype,
              ctx, out):
    if any(isinstance(a, (NDArray, torch.Tensor)) for a in arr_args):
        # per-element parameters: scalars and arrays broadcast to a
        # common shape first
        dev = next(a._data.device if isinstance(a, NDArray) else a.device
                   for a in arr_args if isinstance(a, (NDArray,
                                                       torch.Tensor)))
        datas = [a._data if isinstance(a, NDArray) else
                 a if isinstance(a, torch.Tensor) else
                 torch.tensor(a, dtype=torch.float32, device=dev)
                 for a in arr_args]
        common = np.broadcast_shapes(*[tuple(d.shape) for d in datas])
        arrs = [torch.broadcast_to(d, common) for d in datas]
        return _draw(sample_op, arrs, {"shape": shape, "dtype": dtype}, ctx,
                     out)
    params = dict(scalar_params, shape=shape or (1,), dtype=dtype)
    return _draw(scalar_op, [], params, ctx, out)


def uniform(low=0, high=1, shape=None, dtype="float32", ctx=None, out=None):
    return _dispatch("_random_uniform", "_sample_uniform",
                     {"low": low, "high": high}, (low, high), shape, dtype,
                     ctx, out)


def normal(loc=0, scale=1, shape=None, dtype="float32", ctx=None, out=None):
    return _dispatch("_random_normal", "_sample_normal",
                     {"loc": loc, "scale": scale}, (loc, scale), shape,
                     dtype, ctx, out)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    return normal(loc, scale, shape or (1,), dtype, ctx)


def gamma(alpha=1, beta=1, shape=None, dtype="float32", ctx=None, out=None):
    return _dispatch("_random_gamma", "_sample_gamma",
                     {"alpha": alpha, "beta": beta}, (alpha, beta), shape,
                     dtype, ctx, out)


def exponential(scale=1, shape=None, dtype="float32", ctx=None, out=None):
    return _draw("_random_exponential", [],
                 {"lam": 1.0 / scale, "shape": shape or (1,),
                  "dtype": dtype}, ctx, out)


def poisson(lam=1, shape=None, dtype="float32", ctx=None, out=None):
    return _draw("_random_poisson", [], {"lam": lam, "shape": shape or (1,),
                                         "dtype": dtype}, ctx, out)


def negative_binomial(k=1, p=1, shape=None, dtype="float32", ctx=None,
                      out=None):
    return _draw("_random_negative_binomial", [],
                 {"k": k, "p": p, "shape": shape or (1,), "dtype": dtype},
                 ctx, out)


def generalized_negative_binomial(mu=1, alpha=1, shape=None, dtype="float32",
                                  ctx=None, out=None):
    return _draw("_random_generalized_negative_binomial", [],
                 {"mu": mu, "alpha": alpha, "shape": shape or (1,),
                  "dtype": dtype}, ctx, out)


def multinomial(data, shape=None, get_prob=False, out=None, dtype="int32"):
    return _draw("_sample_multinomial", [data],
                 {"shape": shape, "get_prob": get_prob, "dtype": dtype},
                 None, out)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None):
    return _draw("_random_randint", [], {"low": low, "high": high,
                                         "shape": shape or (1,),
                                         "dtype": dtype}, ctx, out)


def bernoulli(prob=0.5, shape=None, dtype="float32", ctx=None, out=None):
    return _draw("_sample_bernoulli", [], {"prob": prob,
                                           "shape": shape or (1,),
                                           "dtype": dtype}, ctx, out)


def shuffle(data, out=None):
    return _draw("_shuffle", [data], {}, None, out)

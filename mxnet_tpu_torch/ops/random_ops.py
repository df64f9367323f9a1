"""Random sampling ops (the port of ``mxnet_tpu/ops/random_ops.py`` and
of the samplers of ``mxnet_tpu/ops/extra.py``).

Every op takes ``rng=``, the ``torch.Generator`` of one draw of
:mod:`mxnet_tpu_torch._rng` (``apply_op`` passes it), and draws on that
generator's device. ``shape`` and ``dtype`` follow the reference; a
``_random_*`` op takes its parameters as scalars, a ``_sample_*`` op as
arrays, one row of samples per parameter element. The distributions are
the JAX package's; the bits are not (its threefry streams cannot be
reproduced). Gamma draws use Marsaglia and Tsang's method (torch's own
gamma sampler takes no generator); Poisson draws are ``torch.poisson``'s.
"""
from __future__ import annotations

import math

import torch

from ..base import torch_dtype
from .registry import _REGISTRY, Operator, alias


def _reg(name, fn, nout=1):
    _REGISTRY[name] = Operator(name, fn, nout=nout, needs_rng=True,
                               differentiable=False)


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def _dt(dtype):
    return torch_dtype("float32" if dtype is None else dtype)


def _uniform01(rng, shape, dtype=torch.float32):
    return torch.rand(shape, generator=rng, device=rng.device, dtype=dtype)


def _std_normal(rng, shape, dtype=torch.float32):
    return torch.randn(shape, generator=rng, device=rng.device, dtype=dtype)


def standard_gamma(rng, alpha):
    """Gamma(alpha, 1) draws of the shape of ``alpha`` (f32), by
    Marsaglia and Tsang's rejection method, proposals drawn in rounds
    until every element has accepted one; alpha < 1 takes the boost
    ``Gamma(alpha + 1) * U^(1/alpha)``."""
    alpha = alpha.to(torch.float32)
    boost = alpha < 1
    a = torch.where(boost, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    out = torch.zeros_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while True:
        x = _std_normal(rng, a.shape)
        v = (1 + c * x) ** 3
        u = _uniform01(rng, a.shape)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-30)))
        take = ok & todo
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
        if not bool(todo.any()):
            break
    u = _uniform01(rng, a.shape)
    return torch.where(boost, out * u.pow(1.0 / alpha), out)


def _poisson(rng, lam):
    return torch.poisson(lam.to(torch.float32), generator=rng)


def _full(rng, shape, value):
    return torch.full(shape, float(value), device=rng.device)


# ------------------------------------------------- scalar parameters ------
def _random_uniform(rng=None, low=0.0, high=1.0, shape=None,
                    dtype="float32", ctx=None):
    u = _uniform01(rng, _shape(shape), _dt(dtype))
    return low + u * (high - low)


def _random_normal(rng=None, loc=0.0, scale=1.0, shape=None, dtype="float32",
                   ctx=None):
    return loc + scale * _std_normal(rng, _shape(shape), _dt(dtype))


def _random_gamma(rng=None, alpha=1.0, beta=1.0, shape=None, dtype="float32",
                  ctx=None):
    g = standard_gamma(rng, _full(rng, _shape(shape), alpha))
    return (beta * g).to(_dt(dtype))


def _random_exponential(rng=None, lam=1.0, shape=None, dtype="float32",
                        ctx=None):
    e = torch.empty(_shape(shape), device=rng.device,
                    dtype=_dt(dtype)).exponential_(1.0, generator=rng)
    return e / lam


def _random_poisson(rng=None, lam=1.0, shape=None, dtype="float32",
                    ctx=None):
    return _poisson(rng, _full(rng, _shape(shape), lam)).to(_dt(dtype))


def _random_randint(rng=None, low=0, high=1, shape=None, dtype="int32",
                    ctx=None):
    return torch.randint(int(low), int(high), _shape(shape), generator=rng,
                         device=rng.device, dtype=torch_dtype(dtype))


def _nb_from(rng, k, p, shape, dtype):
    lam = standard_gamma(rng, torch.broadcast_to(k, shape)) * (1 - p) / p
    return _poisson(rng, lam).to(_dt(dtype))


def _random_negative_binomial(rng=None, k=1, p=1.0, shape=None,
                              dtype="float32", ctx=None):
    s = _shape(shape)
    return _nb_from(rng, _full(rng, s, k), p, s, dtype)


def _random_gnb(rng=None, mu=1.0, alpha=1.0, shape=None, dtype="float32",
                ctx=None):
    k = 1.0 / alpha
    p = k / (k + mu)
    s = _shape(shape)
    return _nb_from(rng, _full(rng, s, k), p, s, dtype)


_reg("_random_uniform", _random_uniform)
_reg("_random_normal", _random_normal)
_reg("_random_gamma", _random_gamma)
_reg("_random_exponential", _random_exponential)
_reg("_random_poisson", _random_poisson)
_reg("_random_randint", _random_randint)
_reg("_random_negative_binomial", _random_negative_binomial)
_reg("_random_generalized_negative_binomial", _random_gnb)
alias("uniform", "_random_uniform")
alias("normal", "_random_normal")
alias("random_gamma", "_random_gamma")
alias("random_exponential", "_random_exponential")
alias("random_poisson", "_random_poisson")
alias("random_randint", "_random_randint")


# -------------------------------------------------- array parameters ------
def _rows(p, s):
    """``p`` shaped to broadcast against ``p.shape + s``."""
    return p.reshape(p.shape + (1,) * len(s))


def _sample_uniform(low, high, rng=None, shape=None, dtype="float32"):
    s = _shape(shape)
    u = _uniform01(rng, low.shape + s, _dt(dtype))
    return _rows(low, s) + u * _rows(high - low, s)


def _sample_normal(mu, sigma, rng=None, shape=None, dtype="float32"):
    s = _shape(shape)
    n = _std_normal(rng, mu.shape + s, _dt(dtype))
    return _rows(mu, s) + n * _rows(sigma, s)


def _sample_gamma(alpha, beta, rng=None, shape=None, dtype="float32"):
    s = _shape(shape)
    g = standard_gamma(rng, torch.broadcast_to(_rows(alpha, s),
                                               alpha.shape + s))
    return (g * _rows(beta, s)).to(_dt(dtype))


def _sample_multinomial(data, rng=None, shape=None, get_prob=False,
                        dtype="int32"):
    """Draws from the categorical rows of ``data`` (``(..., K)``
    probabilities): ``data.shape[:-1] + shape`` indices, and with
    ``get_prob`` also the log-probability of each draw."""
    s = _shape(shape)
    n = math.prod(s) if s else 1
    logits = torch.log(torch.clamp(data, min=1e-30))
    flat = logits.reshape(-1, logits.shape[-1])
    draws = torch.multinomial(torch.softmax(flat, dim=-1), n,
                              replacement=True, generator=rng)
    out = draws.reshape(data.shape[:-1] + s).to(torch_dtype(dtype))
    if get_prob:
        lp = torch.gather(flat, 1, draws).reshape(out.shape)
        return out, lp
    return out


def _shuffle(data, rng=None):
    perm = torch.randperm(data.shape[0], generator=rng, device=rng.device)
    return data[perm.to(data.device)]


def _bernoulli(rng=None, prob=0.5, shape=None, dtype="float32", ctx=None):
    return (_uniform01(rng, _shape(shape)) < prob).to(torch_dtype(dtype))


_reg("_sample_uniform", _sample_uniform)
_reg("_sample_normal", _sample_normal)
_reg("_sample_gamma", _sample_gamma)
alias("sample_uniform", "_sample_uniform")
alias("sample_normal", "_sample_normal")
alias("sample_gamma", "_sample_gamma")
_reg("_sample_multinomial", _sample_multinomial, nout=-1)
alias("sample_multinomial", "_sample_multinomial")
_reg("_shuffle", _shuffle)
alias("shuffle", "_shuffle")
_reg("_sample_bernoulli", _bernoulli)
alias("bernoulli", "_sample_bernoulli")


# ------------------------------ the samplers of mxnet_tpu/ops/extra.py ----
def _expand(p, sh):
    return torch.broadcast_to(p.reshape(p.shape + (1,) * (len(sh) - p.ndim)),
                              sh)


def _sample_exponential(lam, shape=(), dtype="float32", rng=None):
    sh = tuple(lam.shape) + _shape(shape)
    e = torch.empty(sh, device=rng.device).exponential_(1.0, generator=rng)
    return e / lam.reshape(lam.shape + (1,) * (len(sh) - lam.ndim))


def _sample_poisson(lam, shape=(), dtype="float32", rng=None):
    sh = tuple(lam.shape) + _shape(shape)
    return _poisson(rng, _expand(lam, sh)).to(_dt(dtype))


def _sample_negative_binomial(k, p, shape=(), dtype="float32", rng=None):
    """NB(k, p) as Poisson(Gamma(k, (1-p)/p)), the reference's mixture."""
    sh = tuple(k.shape) + _shape(shape)
    return _nb_from(rng, _expand(k, sh).float(), _expand(p, sh), sh, dtype)


def _sample_gnb(mu, alpha, shape=(), dtype="float32", rng=None):
    """The generalized NB: Poisson(Gamma) with mean ``mu`` and
    dispersion ``alpha``."""
    sh = tuple(mu.shape) + _shape(shape)
    m, a = _expand(mu, sh), _expand(alpha, sh)
    r = 1.0 / torch.clamp(a, min=1e-12)
    lam = standard_gamma(rng, r) * m / r
    return _poisson(rng, lam).to(_dt(dtype))


_reg("_sample_exponential", _sample_exponential)
_reg("_sample_poisson", _sample_poisson)
_reg("_sample_negative_binomial", _sample_negative_binomial)
_reg("_sample_generalized_negative_binomial", _sample_gnb)

"""Elementwise unary, binary, scalar and comparison ops (the port of
``mxnet_tpu/ops/elemwise.py`` and of the internal elemwise names of
``mxnet_tpu/ops/extra.py``), each one PyTorch expression.

Comparison and logical ops return 0/1 in their inputs' dtype (the
reference's NDArray operators), not ``torch.bool``; ``isnan``,
``isinf`` and ``isfinite`` return booleans, as the JAX package's do.
``gelu`` is the tanh form (``jax.nn.gelu``'s default); ``Activation``'s
``gelu`` (in :mod:`.nn`) is the exact one.

:func:`sign` and :func:`relu` keep ``jnp.sign``'s and
``jnp.maximum(x, 0)``'s bits, which ``torch.sign`` and ``torch.relu`` do
not: ``sign`` returns ``x`` itself where it is NaN or ±0, ``relu`` gives
+0 for -0 and NaN for NaN. The other op modules (and the update ops'
twins) take them from here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .registry import _REGISTRY, Operator, alias


def _reg(name, fn, differentiable=True, variadic=False):
    _REGISTRY[name] = Operator(name, fn, differentiable=differentiable,
                               variadic=variadic)


def sign(x):
    """``jnp.sign``: -1, +1, or ``x`` itself where it is NaN or ±0
    (``torch.sign`` gives +0 for both); gradient zero."""
    s = torch.sign(x)
    return torch.where(s == 0, x.detach(), s)


class _Relu(torch.autograd.Function):
    """``jnp.maximum(x, 0)``'s bits in one pass: +0 for -0 (``torch.relu``
    keeps -0), NaN for NaN. The gradient is ``torch.relu``'s: the
    incoming gradient where the output is positive, else 0."""

    @staticmethod
    def forward(ctx, x):
        out = torch.where(x <= 0, 0, x)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        out, = ctx.saved_tensors
        return torch.ops.aten.threshold_backward(g, out, 0)


def relu(x):
    """``max(x, 0)`` with ``jnp.maximum(x, 0)``'s bits."""
    return _Relu.apply(x)


def _cbrt(x):
    return sign(x) * x.abs().pow(1.0 / 3.0)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# ----------------------------------------------------------------- unary ---
_UNARY = {
    "abs": torch.abs, "sign": sign, "ceil": torch.ceil,
    "floor": torch.floor, "rint": torch.round,
    "trunc": torch.trunc, "fix": torch.trunc, "square": torch.square,
    "sqrt": torch.sqrt, "cbrt": _cbrt, "exp": torch.exp, "log": torch.log,
    "log10": torch.log10, "log2": torch.log2, "log1p": torch.log1p,
    "expm1": torch.expm1, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "arcsin": torch.asin, "arccos": torch.acos,
    "arctan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh,
    "tanh": torch.tanh, "arcsinh": torch.asinh, "arccosh": torch.acosh,
    "arctanh": torch.atanh, "degrees": torch.rad2deg,
    "radians": torch.deg2rad, "reciprocal": torch.reciprocal,
    "negative": torch.negative, "erf": torch.erf, "erfinv": torch.erfinv,
    "gammaln": torch.lgamma, "identity": lambda x: x,
}
for _n, _f in _UNARY.items():
    _reg(_n, _f)

_reg("rsqrt", torch.rsqrt)
_reg("rcbrt", lambda x: 1.0 / _cbrt(x))
_reg("gamma", lambda x: torch.exp(torch.lgamma(x)))
_reg("logical_not", lambda x: (x == 0).to(x.dtype), differentiable=False)
_reg("relu", relu)
_reg("sigmoid", torch.sigmoid)
_reg("softsign", lambda x: x / (1 + x.abs()))
_reg("hard_sigmoid", lambda x, alpha=0.2, beta=0.5:
     torch.clamp(alpha * x + beta, 0.0, 1.0))
_reg("softrelu", _softplus)
_reg("gelu", lambda x, approximate=True: F.gelu(
    x, approximate="tanh" if approximate else "none"))
_reg("round", lambda x, decimals=0: torch.round(x, decimals=decimals))
_reg("silu", F.silu)
_reg("log_sigmoid", F.logsigmoid)
_reg("mish", lambda x: x * torch.tanh(_softplus(x)))
_reg("isnan", torch.isnan, differentiable=False)
_reg("isinf", torch.isinf, differentiable=False)
_reg("isfinite", torch.isfinite, differentiable=False)

alias("stop_gradient", "identity")
_reg("BlockGrad", lambda x: x.detach())
alias("make_loss", "identity")

# ------------------------------------------------------- binary broadcast ---
_BINARY = {
    "broadcast_add": torch.add, "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul, "broadcast_div": torch.true_divide,
    "broadcast_mod": torch.remainder, "broadcast_power": torch.pow,
    "broadcast_maximum": torch.maximum, "broadcast_minimum": torch.minimum,
    "broadcast_hypot": torch.hypot, "arctan2": torch.atan2,
    "elemwise_add": torch.add, "elemwise_sub": torch.sub,
    "elemwise_mul": torch.mul, "elemwise_div": torch.true_divide,
}
for _n, _f in _BINARY.items():
    _reg(_n, _f)

alias("broadcast_plus", "broadcast_add")
alias("broadcast_minus", "broadcast_sub")
alias("maximum", "broadcast_maximum")
alias("minimum", "broadcast_minimum")
alias("hypot", "broadcast_hypot")

_CMP = {
    "broadcast_equal": torch.eq, "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt, "broadcast_greater_equal": torch.ge,
    "broadcast_lesser": torch.lt, "broadcast_lesser_equal": torch.le,
    "broadcast_logical_and": torch.logical_and,
    "broadcast_logical_or": torch.logical_or,
    "broadcast_logical_xor": torch.logical_xor,
}


def _cmp_common(f):
    # 0/1 in the inputs' common dtype
    return lambda a, b: f(a, b).to(torch.result_type(a, b))


for _n, _f in _CMP.items():
    _reg(_n, _cmp_common(_f), differentiable=False)

_reg("smooth_l1", lambda x, scalar=1.0: torch.where(
    x.abs() < 1.0 / (scalar * scalar), 0.5 * (scalar * x) ** 2,
    x.abs() - 0.5 / (scalar * scalar)))

# ----------------------------------------------------------- scalar forms ---
_SCALAR = {
    "_plus_scalar": lambda x, scalar: x + scalar,
    "_minus_scalar": lambda x, scalar: x - scalar,
    "_rminus_scalar": lambda x, scalar: scalar - x,
    "_mul_scalar": lambda x, scalar: x * scalar,
    "_div_scalar": lambda x, scalar: x / scalar,
    "_rdiv_scalar": lambda x, scalar: scalar / x,
    "_mod_scalar": lambda x, scalar: torch.remainder(x, scalar),
    # torch.remainder(scalar, x) has no derivative in x
    "_rmod_scalar": lambda x, scalar: scalar - x * torch.floor(scalar / x),
    "_power_scalar": lambda x, scalar: torch.pow(x, scalar),
    "_rpower_scalar": lambda x, scalar: torch.pow(scalar, x),
    "_maximum_scalar": lambda x, scalar: torch.clamp(x, min=scalar),
    "_minimum_scalar": lambda x, scalar: torch.clamp(x, max=scalar),
    "_hypot_scalar": lambda x, scalar: torch.hypot(
        x, torch.full((), scalar, dtype=x.dtype, device=x.device)),
}
for _n, _f in _SCALAR.items():
    _reg(_n, _f)

_SCALAR_CMP = {
    "_equal_scalar": torch.eq, "_not_equal_scalar": torch.ne,
    "_greater_scalar": torch.gt, "_greater_equal_scalar": torch.ge,
    "_lesser_scalar": torch.lt, "_lesser_equal_scalar": torch.le,
}


def _cmp_first(f):
    # 0/1 in the first input's dtype
    return lambda x, scalar: f(x, scalar).to(x.dtype)


for _n, _f in _SCALAR_CMP.items():
    _reg(_n, _cmp_first(_f), differentiable=False)

_reg("where", lambda cond, x, y: torch.where(cond != 0, x, y))
_reg("zeros_like", lambda a, dtype=None, shape=None: torch.zeros(
    a.shape if shape is None else shape, dtype=a.dtype if dtype is None
    else torch_dtype(dtype), device=a.device), differentiable=False)
_reg("ones_like", lambda a, dtype=None, shape=None: torch.ones(
    a.shape if shape is None else shape, dtype=a.dtype if dtype is None
    else torch_dtype(dtype), device=a.device), differentiable=False)

# ------------------------------------------------- internal elemwise names --
# (mxnet_tpu/ops/extra.py: the names behind the NDArray operators)
for _n, _f in [("_equal", torch.eq), ("_not_equal", torch.ne),
               ("_greater", torch.gt), ("_greater_equal", torch.ge),
               ("_lesser", torch.lt), ("_lesser_equal", torch.le),
               ("_logical_and", torch.logical_and),
               ("_logical_or", torch.logical_or),
               ("_logical_xor", torch.logical_xor)]:
    _reg(_n, (lambda f: lambda a, b: f(a, b).to(a.dtype))(_f),
         differentiable=False)

for _n, _f in [("_logical_and_scalar", lambda a, s: torch.logical_and(
                    a, torch.full((), s != 0, device=a.device))),
               ("_logical_or_scalar", lambda a, s: torch.logical_or(
                   a, torch.full((), s != 0, device=a.device))),
               ("_logical_xor_scalar", lambda a, s: torch.logical_xor(
                   a != 0, torch.full((), s != 0, device=a.device)))]:
    _reg(_n, (lambda f: lambda a, scalar=0.0: f(a, scalar).to(a.dtype))(_f),
         differentiable=False)

_reg("_mod", torch.remainder)
_reg("_power", torch.pow)
_reg("_grad_add", torch.add)
_reg("add_n", lambda arrays: sum(arrays[1:], arrays[0]), variadic=True)
alias("ElementWiseSum", "add_n")
_reg("digamma", torch.digamma)
_reg("_square_sum", lambda x, axis=None, keepdims=False:
     torch.sum(torch.square(x),
               dim=(tuple(range(x.ndim)) if axis is None else axis),
               keepdim=keepdims))

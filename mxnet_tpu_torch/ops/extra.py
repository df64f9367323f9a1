"""The long tail of ``mxnet_tpu/ops/extra.py``: the multi-tensor update
tail and its reductions, then (the second half of this module) the four
aliases, the output layers with their own backward, the spatial, index,
shape, contrib, image and ``_npx_``/``_npi_`` ops.

The ``multi_*``, ``preloaded_multi_*`` and ``_multi_*adamw_update`` ops
are functional, as the JAX package's: they return the updated weights
(and states) in fresh arrays and leave their inputs as they were. Each
is one launch of the multi-tensor update kernel on the card
(:func:`.optimizer_ops.multi_apply`: the weights and states are cloned,
then updated in place in one launch over all of them, counted under the
op's name); on the CPU the same rule's twin runs, parameter by
parameter. With ``out=`` the results are written there (the op takes
the targets itself): given the op's own weights and states as targets,
it updates them in place in one launch and copies nothing, as the
reference's ``out=weights`` idiom does. A ``multi_*`` op takes its per-weight ``lrs``/``wds`` as host
lists, which go into the launch's rows; a ``preloaded_multi_*`` op takes
them as arrays (its last two inputs), and the kernel reads them on the
card through addresses in the rows, with no host sync. The
``_multi_*adamw_update`` ops take ``rescale_grad`` as their last input,
an array read the same way.

A clip bound here is off unless positive, as in the JAX ops. The mp
ops cast the 16-bit gradient to f32 before scaling it (the reference
MXNet kernels' order; the JAX ops scale it in 16 bits first).

The reductions (``all_finite``, ``multi_all_finite``, ``multi_sum_sq``,
``multi_lars``, ``reset_arrays``) have no kernel in the JAX package and
are plain PyTorch here (``torch._foreach_norm`` over the list).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..base import torch_dtype
from .elemwise import relu, sign
from .linalg import _f32_products
from .optimizer_ops import (RULES, _clip, _div, clip_bound, lamb_ratio,
                            multi_apply)
from .registry import _REGISTRY, Operator

__all__ = []


def _reg(name, fn, variadic=True):
    _REGISTRY[name] = Operator(name, fn, nout=2, variadic=variadic,
                               differentiable=False)


# ------------------------------------------------------------ reductions --
def _all_finite(data, init_output=True):
    return torch.isfinite(data).all().reshape(1).to(torch.float32)


def _max_abs(arrays):
    """Each array's largest magnitude (inf or NaN where it holds one)."""
    return torch._foreach_norm([a.float() if not a.is_floating_point()
                                else a for a in arrays], float("inf"))


def _multi_all_finite(arrays, num_arrays=1, init_output=True):
    norms = torch.stack([n.float() for n in _max_abs(arrays)])
    return torch.isfinite(norms).all().reshape(1).to(torch.float32)


def _multi_sum_sq(arrays, num_arrays=1):
    """Each array's sum of squares, a one-element array in its dtype."""
    norms = torch._foreach_norm(list(arrays), 2)
    return tuple((n.float() * n.float()).to(a.dtype).reshape(1)
                 for n, a in zip(norms, arrays))


def _reset_arrays(arrays, num_arrays=1):
    return tuple(torch.zeros_like(a) for a in arrays)


def _multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001,
                eps=1e-8, rescale_grad=1.0):
    """Layer-wise learning rates: ``lr * eta * |w| / (|g| + wd |w| +
    eps)`` where both norms are positive, else ``lr``."""
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = torch.sqrt(grads_sum_sq) * rescale_grad
    ratio = eta * w_norm / (g_norm + wds * w_norm + eps)
    return torch.where((w_norm > 0) & (g_norm > 0), lrs * ratio, lrs)


_reg("all_finite", _all_finite, variadic=False)
_reg("multi_all_finite", _multi_all_finite)
_reg("multi_sum_sq", _multi_sum_sq)
_reg("reset_arrays", _reset_arrays)
_reg("multi_lars", _multi_lars, variadic=False)


# ------------------------------------------------------- update ops ------
def _groups(arrays, n_per, num=None):
    n = len(arrays) // n_per if num is None else int(num)
    return [list(arrays[i * n_per:(i + 1) * n_per]) for i in range(n)]


def _out_groups(out, n_out):
    """``out=`` (the op's outputs in order) grouped by parameter."""
    return None if out is None else _groups(list(out), n_out)


def _writes_out(fn):
    """Mark an impl that writes ``out=`` itself (``apply_op`` hands it
    the targets): given its own inputs as targets, the op updates them
    in place in one launch, with nothing copied."""
    fn.writes_out = True
    return fn


def _flat(outs):
    return tuple(t for ts in outs for t in ts)


def _host_kws(num, lrs, wds, **common):
    return [dict(common, lr=float(lrs[i]), wd=float(wds[i]))
            for i in range(num)]


def _array_kws(groups, lrs, wds, **common):
    """Per-weight kwargs with lr and wd taken from the arrays ``lrs`` and
    ``wds``: on the card as addresses the kernel reads (``lr_arr``,
    ``wd_arr``: one f32 element each), on the CPU as 0-d tensors the
    twin computes with."""
    dev = groups[0][0].device if groups else lrs.device
    lr32 = lrs.to(device=dev, dtype=torch.float32).reshape(-1)
    wd32 = wds.to(device=dev, dtype=torch.float32).reshape(-1)
    if dev.type == "cpu":
        return [dict(common, lr=lr32[i], wd=wd32[i])
                for i in range(len(groups))]
    return [dict(common, lr_arr=lr32[i:i + 1], wd_arr=wd32[i:i + 1])
            for i in range(len(groups))]


def _n_out(rule):
    return len(RULES[rule].mutates)


def _sgd_family(name, rule, n_per):
    if "mom" not in rule:
        # the JAX op's positional order: no momentum
        @_writes_out
        def plain(arrays, num_weights=1, lrs=(), wds=(), rescale_grad=1.0,
                  clip_gradient=-1.0, out=None):
            return impl(arrays, num_weights, lrs, wds, 0.0, rescale_grad,
                        clip_gradient, out=out)
        plain.__name__ = name
    else:
        plain = None

    @_writes_out
    def impl(arrays, num_weights=1, lrs=(), wds=(), momentum=0.0,
             rescale_grad=1.0, clip_gradient=-1.0, out=None):
        groups = _groups(arrays, n_per, num_weights)
        common = dict(rescale_grad=rescale_grad,
                      clip_gradient=clip_bound(clip_gradient))
        if "mom" in rule:
            common["momentum"] = momentum
        kws = _host_kws(len(groups), lrs, wds, **common)
        return _flat(multi_apply(rule, groups, kws, counter=name,
                                 out=_out_groups(out, _n_out(rule))))
    impl.__name__ = name
    return plain or impl


def _preloaded_family(name, rule, n_per):
    if "mom" not in rule:
        # the JAX op's positional order: no momentum
        @_writes_out
        def plain(arrays, rescale_grad=1.0, clip_gradient=-1.0, out=None,
                  **_):
            return impl(arrays, 0.0, rescale_grad, clip_gradient, out=out)
        plain.__name__ = name
    else:
        plain = None

    @_writes_out
    def impl(arrays, momentum=0.0, rescale_grad=1.0, clip_gradient=-1.0,
             out=None, **_):
        lrs, wds = arrays[-2], arrays[-1]
        groups = _groups(arrays[:-2], n_per)
        common = dict(rescale_grad=rescale_grad,
                      clip_gradient=clip_bound(clip_gradient))
        if "mom" in rule:
            common["momentum"] = momentum
        kws = _array_kws(groups, lrs, wds, **common)
        return _flat(multi_apply(rule, groups, kws, counter=name,
                                 out=_out_groups(out, _n_out(rule))))
    impl.__name__ = name
    return plain or impl


for _name, _rule, _n in (
        ("multi_sgd_update", "sgd_update", 2),
        ("multi_sgd_mom_update", "sgd_mom_update", 3),
        ("multi_mp_sgd_update", "mp_sgd_update", 3),
        ("multi_mp_sgd_mom_update", "mp_sgd_mom_update", 4)):
    _reg(_name, _sgd_family(_name, _rule, _n))
    _reg("preloaded_" + _name, _preloaded_family("preloaded_" + _name,
                                                 _rule, _n))


def _rescale_arr(arr, dev):
    return arr.to(device=dev, dtype=torch.float32).reshape(1)


def _adamw_kws(n, rescale, lrs, wds, etas, beta1, beta2, epsilon,
               clip_gradient):
    return [dict(lr=float(lrs[i]), wd=float(wds[i]), eta=float(etas[i]),
                 beta1=beta1, beta2=beta2, epsilon=epsilon,
                 clip_gradient=clip_bound(clip_gradient),
                 rescale_grad_arr=rescale) for i in range(n)]


@_writes_out
def _multi_adamw_update(arrays, lrs=(), wds=(), etas=(), beta1=0.9,
                        beta2=0.999, epsilon=1e-8, clip_gradient=-1.0,
                        out=None, **_):
    """AdamW over (weight, grad, mean, var) groups and, last, the
    rescale array: returns (weight, mean, var) per group. 16-bit weights
    are updated through an f32 copy (the mp rule), as the JAX op
    computes in f32 and casts back."""
    groups = _groups(arrays[:-1], 4)
    if not groups:
        return ()
    rescale = _rescale_arr(arrays[-1], groups[0][0].device)
    kws = _adamw_kws(len(groups), rescale, lrs, wds, etas, beta1, beta2,
                     epsilon, clip_gradient)
    name = "_multi_adamw_update"
    if groups[0][0].dtype == torch.float32:
        return _flat(multi_apply("_adamw_update", groups, kws, counter=name,
                                 out=_out_groups(out, 3)))
    # 16-bit weights: the mp rule over an f32 copy of each, a scratch
    # master the rule updates in place
    masters = [g[0].float() for g in groups]
    targets = _out_groups(out, 3) or [
        [torch.empty_like(g[0]), torch.empty_like(g[2]),
         torch.empty_like(g[3])] for g in groups]
    outs = multi_apply("_mp_adamw_update",
                       [g + [m] for g, m in zip(groups, masters)], kws,
                       counter=name,
                       out=[t + [m] for t, m in zip(targets, masters)])
    return _flat(o[:3] for o in outs)


@_writes_out
def _multi_mp_adamw_update(arrays, lrs=(), wds=(), etas=(), beta1=0.9,
                           beta2=0.999, epsilon=1e-8, clip_gradient=-1.0,
                           out=None, **_):
    """AdamW over (weight, grad, mean, var, weight32) groups and, last,
    the rescale array: returns (weight, mean, var, weight32) per
    group."""
    groups = _groups(arrays[:-1], 5)
    if not groups:
        return ()
    rescale = _rescale_arr(arrays[-1], groups[0][0].device)
    kws = _adamw_kws(len(groups), rescale, lrs, wds, etas, beta1, beta2,
                     epsilon, clip_gradient)
    return _flat(multi_apply("_mp_adamw_update", groups, kws,
                             counter="_multi_mp_adamw_update",
                             out=_out_groups(out, 4)))


_reg("_multi_adamw_update", _multi_adamw_update)
_reg("_multi_mp_adamw_update", _multi_mp_adamw_update)


# ------------------------------------- the LAMB and AdaGrad update tail --
# Plain PyTorch on either device, in the JAX ops' order (the mp ops scale
# the 16-bit gradient in its dtype, then cast it to f32, as the JAX ops
# do). Each is registered with the reference's nout and mutates; none is
# differentiated.
def _f32(x):
    return x.to(torch.float32)


def _mp_lamb_phase1(weight, grad, mean, var, weight32, beta1=0.9,
                    beta2=0.999, epsilon=1e-6, t=1, bias_correction=True,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB's phase 1 over an f32 master copy: (the step, the new mean,
    the new var). The reference registers it with ``mutates=(2, 3)``, so
    through ``apply_op`` its first two results land in ``mean`` and
    ``var``, as they do there."""
    g = _f32(_clip(grad * rescale_grad, clip_gradient))
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * torch.square(g)
    if bias_correction:
        mh, vh = _div(m, 1 - beta1 ** t), _div(v, 1 - beta2 ** t)
    else:
        mh, vh = m, v
    return mh / (torch.sqrt(vh) + epsilon) + wd * weight32, m, v


def _mp_lamb_phase2(weight, g, r1, r2, weight32, lr=0.01,
                    lower_bound=-1.0, upper_bound=-1.0):
    """LAMB's phase 2 on the master copy: (the weight in its dtype, the
    new master copy)."""
    w32 = weight32 - lr * lamb_ratio(r1, r2, lower_bound, upper_bound) * g
    return w32.to(weight.dtype), w32


def _lamb_step(w32, g, m, v, lr, wd, beta1, beta2, epsilon, t,
               rescale_grad, clip_gradient, lower_bound, upper_bound):
    """One tensor of the multi-tensor LAMB: phase 1, the norms and phase
    2 in one (ratio 1 where the weight's norm is 0)."""
    gg = _clip(_f32(g) * rescale_grad, clip_gradient)
    m_new = beta1 * m + (1 - beta1) * gg
    v_new = beta2 * v + (1 - beta2) * gg * gg
    mhat = _div(m_new, 1 - beta1 ** t)
    vhat = _div(v_new, 1 - beta2 ** t)
    gdash = mhat / (torch.sqrt(vhat) + epsilon) + wd * w32
    wnorm = torch.sqrt(torch.sum(w32 * w32))
    gnorm = torch.sqrt(torch.sum(gdash * gdash))
    one = torch.ones_like(wnorm)
    ratio = torch.where(gnorm > 0, wnorm / gnorm, one)
    if lower_bound > 0:
        ratio = torch.clamp_min(ratio, lower_bound)
    if upper_bound > 0:
        ratio = torch.clamp_max(ratio, upper_bound)
    ratio = torch.where(wnorm > 0, ratio, one)
    return w32 - lr * ratio * gdash, m_new, v_new


def _multi_lamb(arrays, n_per, mp, learning_rates, wds, step_count, **kw):
    outs = []
    for i, group in enumerate(_groups(arrays, n_per)):
        w, g, m, v = group[:4]
        w32 = group[4] if mp else _f32(w)
        new32, m_new, v_new = _lamb_step(
            w32, g, m, v, float(learning_rates[i]), float(wds[i]),
            t=int(step_count[i]), **kw)
        outs.extend([new32.to(w.dtype), m_new, v_new] +
                    ([new32] if mp else []))
    return tuple(outs)


def _multi_lamb_update(arrays, learning_rates=(), wds=(), beta1=0.9,
                       beta2=0.999, epsilon=1e-6, step_count=(),
                       rescale_grad=1.0, clip_gradient=-1.0,
                       lower_bound=-1.0, upper_bound=-1.0, **kw):
    """LAMB over groups (weight, grad, mean, var): (weight, mean, var)
    anew for each, in fresh tensors."""
    return _multi_lamb(arrays, 4, False, learning_rates, wds, step_count,
                       beta1=beta1, beta2=beta2, epsilon=epsilon,
                       rescale_grad=rescale_grad,
                       clip_gradient=clip_gradient,
                       lower_bound=lower_bound, upper_bound=upper_bound)


def _multi_mp_lamb_update(arrays, learning_rates=(), wds=(), beta1=0.9,
                          beta2=0.999, epsilon=1e-6, step_count=(),
                          rescale_grad=1.0, clip_gradient=-1.0,
                          lower_bound=-1.0, upper_bound=-1.0, **kw):
    """LAMB over groups (weight, grad, mean, var, weight32): (weight,
    mean, var, weight32) anew for each."""
    return _multi_lamb(arrays, 5, True, learning_rates, wds, step_count,
                       beta1=beta1, beta2=beta2, epsilon=epsilon,
                       rescale_grad=rescale_grad,
                       clip_gradient=clip_gradient,
                       lower_bound=lower_bound, upper_bound=upper_bound)


def _sparse_adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7,
                           wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """AdaGrad that leaves the rows whose gradient is all zero as they
    were (the dense form of the reference's lazy AdaGrad)."""
    g = _clip(grad * rescale_grad, clip_gradient)
    row_nonzero = (g != 0).reshape(g.shape[0], -1).any(dim=1).reshape(
        (-1,) + (1,) * (g.ndim - 1))
    h_new = history + g * g
    upd = lr * g / (torch.sqrt(h_new) + epsilon) + lr * wd * weight
    return torch.where(row_nonzero, weight - upd, weight), h_new


def _group_adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-5,
                          rescale_grad=1.0, clip_gradient=-1.0):
    """AdaGrad with one history value a row: the mean of the row's
    squared gradient."""
    g = _clip(grad * rescale_grad, clip_gradient)
    red = tuple(range(1, g.ndim))
    sq = g * g
    h_new = history + (torch.mean(sq, dim=red) if red else sq).reshape(
        history.shape)
    scale = (torch.sqrt(h_new) + epsilon).reshape(
        (-1,) + (1,) * (g.ndim - 1))
    return weight - lr * g / scale, h_new


for _name, _fn, _nout, _mut in (
        ("mp_lamb_update_phase1", _mp_lamb_phase1, 3, (2, 3)),
        ("mp_lamb_update_phase2", _mp_lamb_phase2, 2, (0, 4)),
        ("_sparse_adagrad_update", _sparse_adagrad_update, 2, (0, 2)),
        ("_contrib_group_adagrad_update", _group_adagrad_update, 2, (0, 2))):
    _REGISTRY[_name] = Operator(_name, _fn, nout=_nout, differentiable=False,
                                mutates=_mut)
_reg("_multi_lamb_update", _multi_lamb_update)
_reg("_multi_mp_lamb_update", _multi_mp_lamb_update)


# =================================================================== the
# rest of the JAX module: the aliases, the output layers with their own
# backward, the spatial ops, the index and shape tail, the contribs, the
# image ops and the _npx_/_npi_ tails. None has a kernel in the JAX
# package: each is plain PyTorch here.
# =================================================================== ---
from . import elemwise as _elemwise, nn as _nn  # noqa: E402,F401
from .registry import alias  # noqa: E402

alias("MakeLoss", "make_loss")
alias("BatchNorm_v1", "BatchNorm")
alias("Convolution_v1", "Convolution")
alias("Pooling_v1", "Pooling")


def _op(name, fn, **kw):
    _REGISTRY[name] = Operator(name, fn, **kw)


def _mm(a, b):
    """``torch.matmul`` at f32 accuracy (TF32 off on the card)."""
    with _f32_products((a, b)):
        return torch.matmul(a, b)


def _scalar(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def jnp_linspace(start, stop, num, endpoint=True, dtype=torch.float32,
                 device="cpu"):
    """``jnp.linspace``'s arithmetic: ``start * (1 - t) + stop * t`` with
    ``t = i / div`` in ``dtype``, the endpoint appended as given (so the
    values are JAX's bits, not ``torch.linspace``'s)."""
    num = int(num)
    div = (num - 1) if endpoint else num
    if num <= 1:
        return torch.full((num,), float(start), dtype=dtype, device=device)
    t = torch.arange(div, dtype=dtype, device=device) / torch.tensor(
        float(div), dtype=dtype, device=device)
    s = torch.tensor(float(start), dtype=dtype, device=device)
    e = torch.tensor(float(stop), dtype=dtype, device=device)
    out = s * (1 - t) + e * t
    if endpoint:
        out = torch.cat([out, e.reshape(1)])
    return out


# ------------------------------------------------- output layers --------
# Their gradient is not the autograd of their forward: the regression
# outputs return (pred - label) * grad_scale whatever head gradient
# arrives, as the JAX ops' custom_vjp do.
def _output_layer(name, fwd, bwd):
    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, data, label, grad_scale):
            out = fwd(data)
            ctx.save_for_backward(out, label)
            ctx.grad_scale = grad_scale
            return out

        @staticmethod
        def backward(ctx, g):
            out, label = ctx.saved_tensors
            return bwd(out, label.reshape(out.shape)) * ctx.grad_scale, \
                None, None

    _Fn.__name__ = name

    def impl(data, label, grad_scale=1.0):
        return _Fn.apply(data, label, grad_scale)
    impl.__name__ = name
    _op(name, impl)


_output_layer("LinearRegressionOutput", lambda x: x,
              lambda out, lab: out - lab)
_output_layer("LogisticRegressionOutput", torch.sigmoid,
              lambda out, lab: out - lab)
_output_layer("MAERegressionOutput", lambda x: x,
              lambda out, lab: sign(out - lab))


class _SVMOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, coef, use_linear):
        ctx.save_for_backward(data, label)
        ctx.args = (margin, coef, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        d, lab = ctx.saved_tensors
        margin, coef, use_linear = ctx.args
        onehot = torch.nn.functional.one_hot(
            lab.to(torch.int64), d.shape[-1]).to(d.dtype)
        score_true = torch.sum(d * onehot, dim=-1, keepdim=True)
        if use_linear:      # L1-SVM subgradient
            viol = ((d - score_true + margin) > 0).to(d.dtype) * (1 - onehot)
            grad = viol - onehot * torch.sum(viol, -1, keepdim=True)
        else:               # L2-SVM
            viol = torch.clamp(d - score_true + margin, min=0.0) * \
                (1 - onehot)
            grad = 2 * viol - onehot * torch.sum(2 * viol, -1, keepdim=True)
        return grad * coef, None, None, None, None


def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False):
    """Identity forward; the backward is the hinge subgradient."""
    return _SVMOutput.apply(data, label, margin, regularization_coefficient,
                            use_linear)


_op("SVMOutput", _svm_output)
_op("SoftmaxActivation", lambda data, mode="instance": torch.softmax(
    data, dim=-1 if mode == "instance" else 1))
_op("IdentityAttachKLSparseReg",
    lambda data, sparseness_target=0.1, penalty=0.001, momentum=0.9: data)


class _GradMult(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, scalar):
        ctx.scalar = scalar
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


class _Straight(torch.autograd.Function):
    """A forward whose gradient passes straight through."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


_op("_contrib_gradientmultiplier",
    lambda data, scalar=1.0: _GradMult.apply(data, scalar))
_op("_contrib_round_ste", lambda data: _Straight.apply(data, torch.round))
_op("_contrib_sign_ste", lambda data: _Straight.apply(data, sign))


# ------------------------------------------------------- spatial ops ----
def _grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """affine: ``data`` (N, 6) -> a sampling grid (N, 2, H, W) of (x, y)
    in [-1, 1]; warp: a flow field (N, 2, H, W) in pixels -> the same in
    normalized coordinates."""
    h, w = target_shape
    if transform_type == "affine":
        n = data.shape[0]
        theta = data.reshape(n, 2, 3)
        kw = dict(dtype=data.dtype, device=data.device)
        gy, gx = torch.meshgrid(jnp_linspace(-1.0, 1.0, h, **kw),
                                jnp_linspace(-1.0, 1.0, w, **kw),
                                indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, -1)
        return torch.einsum("nij,jk->nik", theta, base).reshape(n, 2, h, w)
    n, _, hh, ww = data.shape
    gy, gx = torch.meshgrid(
        torch.arange(hh, dtype=data.dtype, device=data.device),
        torch.arange(ww, dtype=data.dtype, device=data.device),
        indexing="ij")
    x = (data[:, 0] + gx) * 2.0 / max(ww - 1, 1) - 1.0
    y = (data[:, 1] + gy) * 2.0 / max(hh - 1, 1) - 1.0
    return torch.stack([x, y], dim=1)


def _gather_nchw(data, yi, xi):
    """``data[n, :, yi[n], xi[n]]`` for every n: (N, C, *yi.shape[1:])."""
    n, c, h, w = data.shape
    flat = (yi * w + xi).reshape(n, 1, -1).expand(n, c, -1)
    return torch.gather(data.reshape(n, c, h * w), 2, flat).reshape(
        (n, c) + tuple(yi.shape[1:]))


def _bilinear_sampler(data, grid, cudnn_off=None):
    """``data`` (N, C, H, W) sampled at ``grid`` (N, 2, Ho, Wo) of (x, y)
    in [-1, 1]; zero outside."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = gx - x0
    wy = gy - y0

    def gather(yy, xx):
        inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        yc = torch.clamp(yy, 0, h - 1).to(torch.int64)
        xc = torch.clamp(xx, 0, w - 1).to(torch.int64)
        return _gather_nchw(data, yc, xc) * inb[:, None].to(data.dtype)

    return ((1 - wy) * (1 - wx))[:, None] * gather(y0, x0) + \
        ((1 - wy) * wx)[:, None] * gather(y0, x0 + 1) + \
        (wy * (1 - wx))[:, None] * gather(y0 + 1, x0) + \
        (wy * wx)[:, None] * gather(y0 + 1, x0 + 1)


def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear",
                         cudnn_off=None):
    return _bilinear_sampler(data, _grid_generator(loc, transform_type,
                                                   target_shape))


def _roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """Fast R-CNN max pooling over a fixed 4x4 sampling grid per bin (the
    JAX op's static-shape form of the reference's integer bin extents)."""
    ph, pw = pooled_size
    sr = 4
    n, c, h, w = data.shape
    r = rois.shape[0]
    b = rois[:, 0].to(torch.int64)
    x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale)
                      for i in range(1, 5))
    # 0-d divisors: CUDA divides by a Python number through its
    # reciprocal, which can move a sample across a pixel edge
    bw = torch.clamp(x2 - x1 + 1, min=1.0) / _scalar(pw, x1)
    bh = torch.clamp(y2 - y1 + 1, min=1.0) / _scalar(ph, y1)
    ar_y = torch.arange(ph * sr, dtype=data.dtype, device=data.device)
    ar_x = torch.arange(pw * sr, dtype=data.dtype, device=data.device)
    gy = y1[:, None] + (ar_y + 0.5) * bh[:, None] / _scalar(sr, bh)
    gx = x1[:, None] + (ar_x + 0.5) * bw[:, None] / _scalar(sr, bw)
    yc = torch.clamp(gy, 0, h - 1).to(torch.int64)
    xc = torch.clamp(gx, 0, w - 1).to(torch.int64)
    nhwc = data.permute(0, 2, 3, 1)
    samples = nhwc[b[:, None, None], yc[:, :, None], xc[:, None, :]]
    samples = samples.permute(0, 3, 1, 2)           # (R, C, PH*sr, PW*sr)
    return samples.reshape(r, c, ph, sr, pw, sr).amax(dim=(3, 5))


def _crop(args, offset=(0, 0), h_w=(0, 0), center_crop=False, num_args=1):
    """Crop (N, C, H, W) to ``h_w`` or to the second input's spatial
    size."""
    data = args[0]
    th, tw = (args[1].shape[2], args[1].shape[3]) if len(args) > 1 else h_w
    h, w = data.shape[2], data.shape[3]
    oy, ox = ((h - th) // 2, (w - tw) // 2) if center_crop else offset
    return data[:, :, oy:oy + th, ox:ox + tw]


def _im2col(data, kernel=None, stride=None, dilate=None, pad=None):
    """(N, C, H, W) -> (N, C*kh*kw, L), channel-major as the patches of
    ``lax.conv_general_dilated_patches``."""
    nd_ = len(kernel)
    return F.unfold(data, tuple(kernel), dilation=tuple(dilate or (1,) * nd_),
                    padding=tuple(pad or (0,) * nd_),
                    stride=tuple(stride or (1,) * nd_))


def _col2im(data, output_size=None, kernel=None, stride=None, dilate=None,
            pad=None):
    """The adjoint of :func:`_im2col`: columns scatter-added back."""
    nd_ = len(kernel)
    return F.fold(data, tuple(output_size), tuple(kernel),
                  dilation=tuple(dilate or (1,) * nd_),
                  padding=tuple(pad or (0,) * nd_),
                  stride=tuple(stride or (1,) * nd_))


_op("GridGenerator", _grid_generator)
_op("BilinearSampler", _bilinear_sampler)
_op("SpatialTransformer", _spatial_transformer)
_op("ROIPooling", _roi_pooling)
_op("Crop", _crop, variadic=True)
_op("im2col", _im2col)
_op("col2im", _col2im)


# ------------------------------------------------ index and shape tail --
def _split_v2(x, indices=(), axis=0, squeeze_axis=False, sections=0):
    n = x.shape[axis]
    if sections and sections > 0:
        parts = torch.tensor_split(x, int(sections), dim=axis)
    else:
        parts = torch.tensor_split(x, [min(int(i), n) for i in indices],
                                   dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


def _unravel_index(indices, shape=None):
    flat = indices.to(torch.int64)
    out = []
    for s in reversed(shape):
        out.append(torch.remainder(flat, s))
        flat = torch.div(flat, s, rounding_mode="floor")
    return torch.stack(out[::-1]).to(indices.dtype)


def _ravel_multi_index(data, shape=None):
    """Row-major flat indices, each coordinate clipped into its axis (the
    JAX op's ``mode="clip"``)."""
    flat = torch.zeros(data.shape[1:], dtype=torch.int64, device=data.device)
    for i, s in enumerate(shape):
        flat = flat * s + torch.clamp(data[i].to(torch.int64), 0, s - 1)
    return flat.to(data.dtype)


def _slice_index(shape, begin, end, step):
    step = step or (None,) * len(begin)
    sls = [slice(b, e, s if s else None) for b, e, s in zip(begin, end, step)]
    if all((s.step or 1) > 0 for s in sls):
        return tuple(sls)
    # a negative step: index arrays (torch slices step forward only)
    ar = [torch.arange(*sl.indices(n)) for sl, n in zip(sls, shape)]
    return tuple(torch.meshgrid(*ar, indexing="ij"))


def _slice_assign(lhs, rhs, begin=(), end=(), step=()):
    """Functional, as the JAX op: the updated copy of ``lhs``."""
    out = lhs.clone()
    out[_slice_index(lhs.shape, begin, end, step)] = rhs
    return out


def _slice_assign_scalar(lhs, scalar=0.0, begin=(), end=(), step=()):
    out = lhs.clone()
    out[_slice_index(lhs.shape, begin, end, step)] = scalar
    return out


def _histogram(data, bin_cnt=10, range=None, **_):
    """``jnp.histogram``'s counts (float): ``bin_cnt`` equal bins over
    ``range`` (default the data's), the last bin closed."""
    lo, hi = (float(range[0]), float(range[1])) if range is not None else \
        (float(data.min()), float(data.max()))
    x = data.reshape(-1).to(torch.float32)
    edges = jnp_linspace(lo, hi, int(bin_cnt) + 1, device=data.device)
    idx = torch.searchsorted(edges, x, right=True) - 1
    idx = torch.where(x == edges[-1], idx - 1, idx)
    ok = (idx >= 0) & (idx < int(bin_cnt))
    counts = torch.zeros(int(bin_cnt), dtype=torch.float32,
                         device=data.device)
    return counts.index_add_(0, idx[ok], torch.ones_like(x[ok]))


def _linspace_op(start=0.0, stop=1.0, num=50, endpoint=True,
                 dtype="float32", ctx=None, **_):
    return jnp_linspace(start, stop, num, endpoint,
                        device=resolve_device(ctx))


def _zeros_without_dtype(shape=(), ctx=None, dtype=None):
    return torch.zeros(tuple(shape), dtype=torch.float32,
                       device=resolve_device(ctx))


def _arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """Each value emitted ``repeat`` times, so ``n`` outputs cover
    ``ceil(n / repeat)`` steps."""
    n = data.numel() if axis is None else data.shape[axis]
    r = int(repeat)
    vals = torch.arange(-(-n // r), dtype=data.dtype, device=data.device) \
        * step + start
    vals = torch.repeat_interleave(vals, r)[:n]
    return vals.reshape(data.shape if axis is None else (-1,))


def _allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    return torch.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan) \
        * torch.ones(1, dtype=torch.float32, device=a.device)


def _index_array(data, axes=None):
    """Each element's N-d index (int32, as the JAX op's int64 without
    x64)."""
    idx = torch.stack(torch.meshgrid(
        *[torch.arange(s, device=data.device) for s in data.shape],
        indexing="ij"), dim=-1)
    if axes is not None:
        idx = idx[..., list(axes)]
    return idx.to(torch.int32)


def _index_copy(old, idx, new):
    out = old.clone()
    out[idx.to(torch.int64)] = new
    return out


def _edge_id(data, u, v):
    return data[u.to(torch.int64), v.to(torch.int64)]


def _tri_indices(n, offset, lower):
    rows, cols = (np.tril_indices(n, k=offset) if lower
                  else np.triu_indices(n, k=offset))
    return torch.from_numpy(rows), torch.from_numpy(cols)


def _extracttrian(A, offset=0, lower=True):
    rows, cols = _tri_indices(A.shape[-1], offset, lower)
    return A[..., rows.to(A.device), cols.to(A.device)]


def _maketrian(a, offset=0, lower=True):
    """The inverse of :func:`_extracttrian`: the packed vector back into
    an (n, n) matrix, the rest zero."""
    m = a.shape[-1]
    k = abs(offset)
    n = next(c for c in range(1, m + k + 2)
             if len(_tri_indices(c, offset, lower)[0]) == m)
    rows, cols = _tri_indices(n, offset, lower)
    out = torch.zeros(a.shape[:-1] + (n, n), dtype=a.dtype, device=a.device)
    out[..., rows.to(a.device), cols.to(a.device)] = a
    return out


def _scatter_set_nd(lhs, rhs, indices, shape=None):
    out = lhs.clone()
    out[tuple(indices[i].to(torch.int64) for i in range(indices.shape[0]))] \
        = rhs
    return out


def _scatter_where(data, val):
    return torch.where(data != 0, val, torch.zeros((), dtype=data.dtype,
                                                   device=data.device))


def _rnn_param_concat(arrays, dim=0):
    return torch.cat(list(arrays), dim=int(dim))


_op("_split_v2", _split_v2, nout=2)
_op("_unravel_index", _unravel_index, differentiable=False)
_op("_ravel_multi_index", _ravel_multi_index, differentiable=False)
_op("_slice_assign", _slice_assign)
_op("_slice_assign_scalar", _slice_assign_scalar)
_op("_histogram", _histogram, differentiable=False)
_op("_linspace", _linspace_op, differentiable=False)
_op("_zeros_without_dtype", _zeros_without_dtype, differentiable=False)
_op("_contrib_arange_like", _arange_like, differentiable=False)
_op("_contrib_allclose", _allclose, differentiable=False)
_op("_contrib_div_sqrt_dim", lambda data: data / torch.sqrt(
    _scalar(data.shape[-1], data)))
_op("_contrib_quadratic", lambda data, a=0.0, b=0.0, c=0.0:
    a * torch.square(data) + b * data + c)
_op("_contrib_index_array", _index_array, differentiable=False)
_op("_contrib_index_copy", _index_copy)
_op("_contrib_edge_id", _edge_id, differentiable=False)
_op("_rnn_param_concat", _rnn_param_concat, variadic=True)
_op("_linalg_extracttrian", _extracttrian)
_op("_linalg_maketrian", _maketrian)
_op("_scatter_set_nd", _scatter_set_nd)
_op("_scatter_elemwise_div", lambda lhs, rhs: _scatter_where(lhs, lhs / rhs))
_op("_scatter_minus_scalar", lambda data, scalar=0.0: _scatter_where(
    data, data - _scalar(scalar, data)))
_op("_scatter_plus_scalar", lambda data, scalar=0.0: _scatter_where(
    data, data + _scalar(scalar, data)))


# --------------------------------------------------------- contribs -----
_BOX_MEANS = (0.0, 0.0, 0.0, 0.0)
_BOX_STDS = (0.1, 0.1, 0.2, 0.2)


def _box_encode(samples, matches, anchors, refs, means=None, stds=None):
    """Matched corner ``refs`` encoded against corner ``anchors`` as
    normalized offsets; rows whose sample is not positive are zero."""
    means = torch.tensor(means if means is not None else _BOX_MEANS,
                         dtype=anchors.dtype, device=anchors.device)
    stds = torch.tensor(stds if stds is not None else _BOX_STDS,
                        dtype=anchors.dtype, device=anchors.device)
    idx = torch.clamp(matches, min=0).to(torch.int64)[..., None]
    ref = torch.take_along_dim(refs, idx, dim=-2)
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) / 2
    ay = (anchors[..., 1] + anchors[..., 3]) / 2
    gw = ref[..., 2] - ref[..., 0]
    gh = ref[..., 3] - ref[..., 1]
    gx = (ref[..., 0] + ref[..., 2]) / 2
    gy = (ref[..., 1] + ref[..., 3]) / 2
    t = torch.stack([(gx - ax) / aw, (gy - ay) / ah,
                     torch.log(torch.clamp(gw, min=1e-12) / aw),
                     torch.log(torch.clamp(gh, min=1e-12) / ah)], dim=-1)
    t = (t - means) / stds
    valid = (samples > 0.5)[..., None]
    return torch.where(valid, t, torch.zeros((), dtype=t.dtype,
                                             device=t.device)), \
        valid.expand(t.shape).to(t.dtype)


def _box_decode(data, anchors, std0=1.0, std1=1.0, std2=1.0, std3=1.0,
                clip=-1.0, format="corner"):
    if format == "corner":
        aw = anchors[..., 2] - anchors[..., 0]
        ah = anchors[..., 3] - anchors[..., 1]
        ax = (anchors[..., 0] + anchors[..., 2]) / 2
        ay = (anchors[..., 1] + anchors[..., 3]) / 2
    else:
        ax, ay, aw, ah = (anchors[..., i] for i in range(4))
    ox = data[..., 0] * std0 * aw + ax
    oy = data[..., 1] * std1 * ah + ay
    dw = data[..., 2] * std2
    dh = data[..., 3] * std3
    if clip > 0:
        dw = torch.clamp(dw, max=clip)
        dh = torch.clamp(dh, max=clip)
    ow = torch.exp(dw) * aw / 2
    oh = torch.exp(dh) * ah / 2
    return torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)


def _fft(data, compute_size=128):
    """The last axis' FFT, real and imaginary parts interleaved."""
    f = torch.fft.fft(data)
    return torch.stack([f.real, f.imag], dim=-1).reshape(
        data.shape[:-1] + (2 * data.shape[-1],))


def _ifft(data, compute_size=128):
    comp = data.reshape(data.shape[:-1] + (data.shape[-1] // 2, 2))
    z = torch.complex(comp[..., 0], comp[..., 1])
    return torch.fft.ifft(z).real * comp.shape[-2]


def _selfatt_split(qkv, heads, idx):
    t, b, _ = qkv.shape
    proj = qkv.reshape(t, b, heads, 3, -1)[:, :, :, idx, :]
    return proj.permute(1, 2, 0, 3).reshape(b * heads, t, -1)


def _encdec_split(kv, heads, idx):
    t, b, _ = kv.shape
    proj = kv.reshape(t, b, heads, 2, -1)[:, :, :, idx, :]
    return proj.permute(1, 2, 0, 3).reshape(b * heads, t, -1)


def _heads_back(out, b, heads):
    tq = out.shape[1]
    return out.reshape(b, heads, tq, -1).permute(2, 0, 1, 3).reshape(
        tq, b, -1)


def _selfatt_qk(qkv, heads=1):
    q = _selfatt_split(qkv, heads, 0)
    k = _selfatt_split(qkv, heads, 1)
    q = q / torch.sqrt(_scalar(q.shape[-1], q))
    return _mm(q, k.transpose(1, 2))


def _selfatt_valatt(qkv, att, heads=1):
    v = _selfatt_split(qkv, heads, 2)
    return _heads_back(_mm(att, v), qkv.shape[1], heads)


def _encdec_qk(queries, keys_values, heads=1):
    tq, b, _ = queries.shape
    q = queries.reshape(tq, b, heads, -1).permute(1, 2, 0, 3).reshape(
        b * heads, tq, -1)
    q = q / torch.sqrt(_scalar(q.shape[-1], q))
    k = _encdec_split(keys_values, heads, 0)
    return _mm(q, k.transpose(1, 2))


def _encdec_valatt(keys_values, att, heads=1):
    v = _encdec_split(keys_values, heads, 1)
    return _heads_back(_mm(att, v), keys_values.shape[1], heads)


def _count_sketch(data, h, s, out_dim=0, processing_batch_size=32):
    """``out[:, h[j]] += s[j] * data[:, j]``."""
    h = h.reshape(-1).to(torch.int64)
    contrib = data * s.reshape(-1).to(data.dtype)[None, :]
    out = torch.zeros((data.shape[0], int(out_dim)), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, h, contrib)


def _getnnz(data, axis=None):
    return torch.count_nonzero(data, dim=axis).to(torch.int32)


def _boolean_mask(data, index, axis=0, size=None):
    """The entries of ``data`` along ``axis`` where ``index`` is nonzero.
    ``size=None`` is the exact form, sized on the host (one read of
    ``index``); an int ``size`` gives that many rows, the first ones
    selected and the rest zero, with no host read. The JAX op also takes
    the bound from ``npx.dynamic_shape_bound``; the port has no
    ``numpy_extension`` yet (ROADMAP.md, item 14), so the bound is
    passed as ``size=``."""
    sel = index.to(torch.bool).reshape(-1)
    if size is None:
        return torch.index_select(data, axis,
                                  torch.nonzero(sel).reshape(-1))
    size = int(size)
    order = torch.sort((~sel).to(torch.int8), stable=True).indices
    idx = order[:size]
    found = sel[idx]
    if idx.numel() < size:
        pad = size - idx.numel()
        idx = F.pad(idx, (0, pad))
        found = F.pad(found, (0, pad))
    taken = torch.index_select(data, axis, idx)
    shape = [1] * taken.ndim
    shape[axis] = size
    return torch.where(found.reshape(shape), taken,
                       torch.zeros((), dtype=taken.dtype,
                                   device=taken.device))


def _bipartite_matching(data, threshold=1e-12, is_ascend=False, topk=-1):
    """Greedy bipartite matching on the host (a sequential argmax and
    mask), as the JAX op: (row -> column, column -> row), -1 unmatched."""
    scores = data.detach().cpu().numpy()
    squeeze = scores.ndim == 2
    if squeeze:
        scores = scores[None]
    b, n, m = scores.shape
    row_match = np.full((b, n), -1, np.float32)
    col_match = np.full((b, m), -1, np.float32)
    limit = topk if topk > 0 else min(n, m)
    for i in range(b):
        sc = scores[i]
        order = np.argsort(sc.ravel())
        if not is_ascend:
            order = order[::-1]
        k = 0
        for flat in order:
            r, c = divmod(int(flat), m)
            val = sc[r, c]
            if (not is_ascend and val < threshold) or \
                    (is_ascend and val > threshold):
                break
            if row_match[i, r] >= 0 or col_match[i, c] >= 0:
                continue
            row_match[i, r] = c
            col_match[i, c] = r
            k += 1
            if k >= limit:
                break
    if squeeze:
        row_match, col_match = row_match[0], col_match[0]
    return (torch.from_numpy(row_match).to(data.device),
            torch.from_numpy(col_match).to(data.device))


_op("_contrib_box_encode", _box_encode, nout=2, differentiable=False)
_op("_contrib_box_decode", _box_decode)
_op("_contrib_fft", _fft)
_op("_contrib_ifft", _ifft)
_op("_contrib_interleaved_matmul_selfatt_qk", _selfatt_qk)
_op("_contrib_interleaved_matmul_selfatt_valatt", _selfatt_valatt)
_op("_contrib_interleaved_matmul_encdec_qk", _encdec_qk)
_op("_contrib_interleaved_matmul_encdec_valatt", _encdec_valatt)
_op("_contrib_count_sketch", _count_sketch)
_op("_contrib_getnnz", _getnnz, differentiable=False)
_op("_contrib_boolean_mask", _boolean_mask, host_op=True,
    differentiable=False)
_op("_contrib_bipartite_matching", _bipartite_matching, nout=2,
    host_op=True, differentiable=False)


# --------------------------------------------------------- image ops ----
def _image_crop(data, x=0, y=0, width=1, height=1):
    if data.ndim == 3:
        return data[y:y + height, x:x + width, :]
    return data[:, y:y + height, x:x + width, :]


def _linear_weights(m, n, device):
    """``jax.image.resize``'s weight matrix (m, n) for one axis resized
    from m to n samples with ``method="linear"``: the triangle kernel at
    half-pixel centres, widened by the scale when downsampling
    (antialias), each column normalized, columns whose sample lies
    outside the input zeroed. f32 arithmetic in JAX's order."""
    f32 = dict(dtype=torch.float32, device=device)
    inv = float(np.float32(1.0 / (n / m)))
    kscale = max(inv, 1.0)
    sample = (torch.arange(n, **f32) + 0.5) * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(m, **f32)[:, None]) / kscale
    w = torch.clamp(1.0 - x, min=0.0)
    tot = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _nearest_index(m, n, device):
    f32 = dict(dtype=torch.float32, device=device)
    off = (torch.arange(n, **f32) + 0.5) * m / torch.tensor(float(n), **f32)
    return torch.floor(off).to(torch.int64)


def _image_resize(data, size=None, keep_ratio=False, interp=1):
    """HWC or NHWC images resized to ``size`` (w, h): ``interp=0``
    nearest, else ``jax.image.resize``'s linear (the antialiased
    triangle filter of :func:`_linear_weights`), computed in f32; integer
    images are cast back by truncation, as ``astype`` does."""
    if isinstance(size, int):
        size = (size, size)
    h, w = int(size[1]), int(size[0])
    x = data.to(torch.float32)
    hax, wax = (0, 1) if data.ndim == 3 else (1, 2)
    for ax, n in ((hax, h), (wax, w)):
        m = x.shape[ax]
        if m == n:
            continue
        if interp == 0:
            x = torch.index_select(x, ax, _nearest_index(m, n, x.device))
        else:
            wm = _linear_weights(m, n, x.device)
            x = torch.movedim(torch.tensordot(x, wm, dims=([ax], [0])),
                              -1, ax)
    if not data.is_floating_point():
        return x.to(data.dtype)
    return x


def _image_to_tensor(data):
    x = data.to(torch.float32) / 255.0
    return x.permute(2, 0, 1) if data.ndim == 3 else x.permute(0, 3, 1, 2)


def _image_normalize(data, mean=0.0, std=1.0):
    mean = torch.as_tensor(mean, dtype=data.dtype, device=data.device)
    std = torch.as_tensor(std, dtype=data.dtype, device=data.device)
    shape = (-1, 1, 1) if data.ndim == 3 else (1, -1, 1, 1)
    if mean.ndim:
        mean = mean.reshape(shape)
    if std.ndim:
        std = std.reshape(shape)
    return (data - mean) / std


_op("_image_crop", _image_crop)
_op("_image_resize", _image_resize)
_op("_image_to_tensor", _image_to_tensor)
_op("_image_normalize", _image_normalize)


# ------------------------------------------------- _npx_ / _npi_ tail ---
def _npx_reshape(data, newshape=None, reverse=False, order="C"):
    """npx.reshape's codes: -1 infer, -2 copy the remaining dims, 0 copy
    this dim."""
    shape = list(newshape)
    src = list(data.shape)
    if reverse:
        shape, src = shape[::-1], src[::-1]
    out, si = [], 0
    for s in shape:
        if s == 0:
            out.append(src[si])
            si += 1
        elif s == -2:
            out.extend(src[si:])
            si = len(src)
        else:
            out.append(s)
            if s != -1:
                si += 1
    if reverse:
        out = out[::-1]
    return data.reshape(tuple(out))


def _npx_nonzero(data):
    """The indices of the nonzero entries (int32, one row each): sized on
    the host."""
    return torch.nonzero(data).to(torch.int32)


def _npx_constraint_check(data, msg="constraint violated"):
    ok = torch.all(data.to(torch.bool))
    if not ok:
        raise ValueError(str(msg))
    return ok


def _where_lscalar(cond, x, scalar=0.0):
    return torch.where(cond.to(torch.bool), x, _scalar(scalar, x))


def _where_rscalar(cond, y, scalar=0.0):
    return torch.where(cond.to(torch.bool), _scalar(scalar, y), y)


def _where_scalar2(cond, x=0.0, y=0.0):
    f32 = dict(dtype=torch.float32, device=cond.device)
    return torch.where(cond.to(torch.bool), torch.tensor(float(x), **f32),
                       torch.tensor(float(y), **f32))


def _matrix_rank(M, hermitian=False):
    """``jnp.linalg.matrix_rank``: singular values above ``max(M, N) *
    eps * s_max`` counted (int32)."""
    s = torch.linalg.svdvals(M)
    tol = s.amax(dim=-1, keepdim=True) * max(M.shape[-2:]) * \
        torch.finfo(M.dtype).eps
    return torch.sum(s > tol, dim=-1).to(torch.int32)


def _pinv(a, rcond=1e-15):
    """``jnp.linalg.pinv``: singular values at or below ``rcond * s_max``
    dropped."""
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    cutoff = float(rcond) * s.amax(dim=-1, keepdim=True)
    s_inv = torch.where(s > cutoff, 1.0 / s, torch.zeros_like(s))
    return _mm(vh.transpose(-1, -2) * s_inv[..., None, :],
                        u.transpose(-1, -2))


def _tensordot(a, b, axes):
    with _f32_products((a, b)):
        return torch.tensordot(a, b, dims=axes)


def _boolean_mask_assign_scalar(data, mask, value=0.0):
    return torch.where(mask.to(torch.bool), _scalar(value, data), data)


def _boolean_mask_assign_tensor(data, mask, value):
    """numpy's fancy assignment: ``value`` holds one entry per selected
    position, scattered in the mask's order (sized on the host)."""
    m = mask.to(torch.bool)
    out = data.clone()
    count = int(m.sum())
    sel_shape = out[m].shape
    v = value.to(data.dtype).reshape(-1)
    out[m] = v[:count] if v.numel() != math.prod(sel_shape) \
        else v.reshape(sel_shape)
    return out


def _npi_insert(data, obj, values, axis):
    host = np.insert(data.detach().cpu().numpy(), obj,
                     np.asarray(values), axis=axis)
    return torch.from_numpy(np.ascontiguousarray(host)).to(data.device)


def _npi_insert_slice(data, obj=0, values=0.0, axis=None, **kw):
    return _npi_insert(data, int(obj), values, axis)


def _npi_insert_tensor(data, obj, values=0.0, axis=None, **kw):
    return _npi_insert(data, obj.detach().cpu().numpy().astype(np.int64),
                       values, axis)


def _npi_share_memory(a, b):
    same = a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
    return torch.tensor(same, device=a.device)


def _npi_uniform_n(low=0.0, high=1.0, rng=None, size=None, dtype="float32",
                   ctx=None):
    shape = tuple(size) if size is not None else ()
    u = torch.rand(shape, generator=rng, device=rng.device,
                   dtype=torch_dtype(dtype))
    return low + (high - low) * u


def _npi_normal_n(loc=0.0, scale=1.0, rng=None, size=None, dtype="float32",
                  ctx=None):
    shape = tuple(size) if size is not None else ()
    return loc + scale * torch.randn(shape, generator=rng, device=rng.device,
                                     dtype=torch_dtype(dtype))


_op("_npx_relu", lambda data: relu(data))
_op("_npx_sigmoid", torch.sigmoid)
_op("_npx_reshape", _npx_reshape)
_op("_npx_nonzero", _npx_nonzero, host_op=True, differentiable=False)
_op("_npx_constraint_check", _npx_constraint_check, differentiable=False)
_op("_npi_where_lscalar", _where_lscalar)
_op("_npi_where_rscalar", _where_rscalar)
_op("_npi_where_scalar2", _where_scalar2)
_op("_npi_powerd", lambda a, exp=1.0: torch.pow(a, exp))
_op("_npi_matmul", lambda a, b: _mm(a, b))
_op("_npi_tensordot_int_axes", lambda a, b, axes=2: _tensordot(
    a, b, int(axes)))
_op("_npi_matrix_rank_none_tol", _matrix_rank, differentiable=False)
_op("_npi_pinv_scalar_rcond", _pinv)
_op("_npi_boolean_mask_assign_scalar", _boolean_mask_assign_scalar)
_op("_npi_boolean_mask_assign_tensor", _boolean_mask_assign_tensor,
    host_op=True, differentiable=False)
_op("_npi_insert_slice", _npi_insert_slice, host_op=True,
    differentiable=False)
_op("_npi_insert_tensor", _npi_insert_tensor, host_op=True,
    differentiable=False)
_op("_npi_share_memory", _npi_share_memory, host_op=True,
    differentiable=False)
_op("_npi_uniform_n", _npi_uniform_n, needs_rng=True, differentiable=False)
_op("_npi_normal_n", _npi_normal_n, needs_rng=True, differentiable=False)

"""The multi-tensor update tail of ``mxnet_tpu/ops/extra.py`` and its
reductions.

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

import torch

from .optimizer_ops import RULES, clip_bound, multi_apply
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
    return impl


def _preloaded_family(name, rule, n_per):
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
    return impl


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

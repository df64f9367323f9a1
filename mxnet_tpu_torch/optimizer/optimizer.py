"""Optimizers of the port (mirrors ``mxnet_tpu/optimizer/optimizer.py``):
the ``Optimizer`` base with MXNet's bookkeeping and the reference's 20
registered optimizers.

Nine update through one registered update op each (``fused.py``'s
fusable set): SGD (momentum, ``multi_precision`` through ``mp_sgd_*``),
NAG, Adam, AdamW, AdaGrad, RMSProp (plain and centered), Ftrl, Signum
and SignSGD. Each runs its op through :func:`~mxnet_tpu_torch.ops.
invoke.apply_op` (``ops/optimizer_ops.py``), which writes the weight and
the states in place: the twin on the CPU, the multi-tensor kernel on the
card. The rules are MXNet's, not ``torch.optim``'s: Adam folds the bias
correction into the learning rate on the host, ``lr * sqrt(1 - beta2^t)
/ (1 - beta1^t)``, and adds ``epsilon`` to ``sqrt(v)`` of the
uncorrected ``v``; the gradient is ``grad * rescale_grad``, clipped to
``+-clip_gradient``; ``t`` is counted per parameter index; ``lr_mult``/
``wd_mult`` come from the Parameter (``param_dict``), the per-index or
the per-name tables. All of it runs on the host in float64.

The other eleven are the reference's arithmetic on tensors, operation by
operation (none is fusable, as in the reference): AdaDelta, Adamax,
Nadam (``m_schedule`` kept on the optimizer), FTML (its own arithmetic,
not the ``ftml_update`` op, as the reference's class), LAMB (the ops
``lamb_update_phase1`` / ``phase2`` with the two norms between them on
the card), LARS and LBSGD (their norms read on the host, as the
reference's ``asscalar``), DCASGD, SGLD (its noise from ``nd.random``'s
``(seed, position)`` draws, so not JAX's bits), GroupAdaGrad and Test.

Row-sparse gradients (``nd.sparse.RowSparseNDArray``, from
``Embedding(sparse_grad=True)``) take the lazy updates of SGD and Adam
under ``lazy_update=True`` (:func:`_rsp_grad_rows`): only the rows the
gradient names change, in the weight and in the states, and every other
row keeps its bits. The repeats of a row are summed in a fixed order
(a stable sort of the ids, then a sum over each run, in the order the
rows came), so the card repeats its bits. Other optimizers read a
row-sparse gradient densely, as the reference's ops do.
"""
from __future__ import annotations

import functools
import math

import torch

from ..ops.invoke import apply_op
from ..ops.optimizer_ops import _div

__all__ = ["Optimizer", "register", "create", "SGD", "NAG", "Adam", "AdamW",
           "AdaGrad", "AdaDelta", "Adamax", "Nadam", "RMSProp", "FTML",
           "Ftrl", "LAMB", "LARS", "DCASGD", "SGLD", "Signum", "SignSGD",
           "LBSGD", "GroupAdaGrad", "Test"]

_LOW = (torch.float16, torch.bfloat16)


class Optimizer:
    """Base optimizer (reference: python/mxnet/optimizer/optimizer.py:36)."""

    opt_registry = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, aggregate_num=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if self.lr_scheduler is not None:
            if learning_rate is not None:
                self.lr_scheduler.base_lr = learning_rate
            self.lr = self.lr_scheduler.base_lr
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.aggregate_num = aggregate_num
        if param_idx2name is None:
            param_idx2name = {}
        assert isinstance(param_idx2name, dict), \
            "param_idx2name should be a dict of param indexes to names."
        self.idx2name = param_idx2name.copy()
        self.param_dict = param_dict if param_dict else {}

    @staticmethod
    def register(klass):
        """Register under the lowercased class name."""
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError(f"Cannot find optimizer {name}")

    def create_state(self, index, weight):
        """The states of one parameter (momentum etc.): a tensor, a tuple
        of them, or None."""
        return None

    def create_state_multi_precision(self, index, weight):
        """With ``multi_precision``, a 16-bit weight's states are
        ``(states of an f32 master copy, the master copy)``."""
        if self.multi_precision and weight.dtype in _LOW:
            weight_master_copy = weight.detach().to(torch.float32)
            return (self.create_state(index, weight_master_copy),
                    weight_master_copy)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and weight.dtype in _LOW:
            weight32 = state[1]
            grad32 = grad.to(torch.float32)
            self.update(index, weight32, grad32, state[0])
            with torch.no_grad():
                weight.copy_(weight32)
        else:
            self.update(index, weight, grad, state)

    @property
    def learning_rate(self):
        """The current base lr (the scheduler's at ``num_update``)."""
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined.")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        """lr multipliers by index or by parameter name (the reference's
        symbol attributes have no counterpart: the port has no symbol)."""
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if not isinstance(index, (list, tuple)):
            index = [index]
        for idx in index:
            if idx not in self._index_update_count:
                self._index_update_count[idx] = self.begin_num_update
            self._index_update_count[idx] += 1
            self.num_update = max(self._index_update_count[idx],
                                  self.num_update)

    def _get_lrs(self, indices):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        lrs = [lr for _ in indices]
        for i, index in enumerate(indices):
            if index in self.param_dict:
                lrs[i] *= self.param_dict[index].lr_mult
            elif index in self.lr_mult:
                lrs[i] *= self.lr_mult[index]
            elif index in self.idx2name:
                lrs[i] *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lrs

    def _get_lr(self, index):
        return self._get_lrs([index])[0]

    def _get_wds(self, indices):
        wds = [self.wd for _ in indices]
        for i, index in enumerate(indices):
            if index in self.param_dict:
                wds[i] *= self.param_dict[index].wd_mult
            elif index in self.wd_mult:
                wds[i] *= self.wd_mult[index]
            elif index in self.idx2name:
                wds[i] *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wds

    def _get_wd(self, index):
        return self._get_wds([index])[0]


register = Optimizer.register
create = Optimizer.create_optimizer


def _common(self, index):
    """(lr, wd, common kwargs) for one parameter update; counts it."""
    self._update_count(index)
    lr = self._get_lr(index)
    wd = self._get_wd(index)
    kwargs = {"rescale_grad": self.rescale_grad}
    if self.clip_gradient is not None:
        kwargs["clip_gradient"] = self.clip_gradient
    return lr, wd, kwargs


def _zeros(weight):
    return torch.zeros_like(weight, requires_grad=False)


def _dense(grad):
    """A gradient as a tensor (a row-sparse one densified, as the
    reference's ops read it)."""
    return getattr(grad, "_data", grad)


def _is_rsp(grad):
    from ..ndarray.sparse import RowSparseNDArray
    return isinstance(grad, RowSparseNDArray)


def _rsp_grad_rows(self, grad):
    """(row ids, their gradient rows) of a row-sparse gradient: the ids
    each once, sorted, each row the sum of its repeats in a fixed order
    (``sparse.summed_rows``), then rescaled and clipped — the front half
    of every lazy update. The run count is read on the host (the
    reference's lazy update is eager only too)."""
    from ..ndarray.sparse import summed_rows
    rows, g = summed_rows(grad._indices, grad._values)
    g = g * self.rescale_grad
    if self.clip_gradient is not None:
        g = g.clamp(-self.clip_gradient, self.clip_gradient)
    return rows, g


def _no_grad(fn):
    """Run an update (tensor arithmetic on the weight, an
    ``nn.Parameter``) off the autograd tape."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.no_grad():
            return fn(*args, **kwargs)
    return wrapped


@register
class SGD(Optimizer):
    """SGD with momentum (``sgd_update`` / ``sgd_mom_update``; with
    ``multi_precision`` on 16-bit weights ``mp_sgd_update`` /
    ``mp_sgd_mom_update``)."""

    def __init__(self, momentum=0.0, lazy_update=True, learning_rate=0.01,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros(weight)
        return None

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and weight.dtype in _LOW:
            weight32 = weight.detach().to(torch.float32)
            return (self.create_state(index, weight32), weight32)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        if self.lazy_update and _is_rsp(grad):
            return self._update_rsp(index, weight, grad, state)
        lr, wd, kwargs = _common(self, index)
        if state is not None:
            apply_op("sgd_mom_update", [weight, grad, state],
                     dict(lr=lr, wd=wd, momentum=self.momentum, **kwargs))
        else:
            apply_op("sgd_update", [weight, grad], dict(lr=lr, wd=wd,
                                                        **kwargs))

    @_no_grad
    def _update_rsp(self, index, weight, grad, state):
        """Lazy update: only the gradient's rows change, their weight
        decay and momentum included (the reference's SGD._update_rsp)."""
        lr, wd, _ = _common(self, index)
        rows, g = _rsp_grad_rows(self, grad)
        wr = weight[rows]
        g = g.to(wr.dtype) + wd * wr
        if state is not None:
            mr = self.momentum * state[rows] + g
            state.index_copy_(0, rows, mr)
            weight.index_copy_(0, rows, wr - lr * mr)
        else:
            weight.index_copy_(0, rows, wr - lr * g)

    def update_multi_precision(self, index, weight, grad, state):
        if not (self.multi_precision and weight.dtype in _LOW):
            return self.update(index, weight, grad, state)
        lr, wd, kwargs = _common(self, index)
        mom, weight32 = state
        if mom is not None:
            apply_op("mp_sgd_mom_update", [weight, grad, mom, weight32],
                     dict(lr=lr, wd=wd, momentum=self.momentum, **kwargs))
        else:
            apply_op("mp_sgd_update", [weight, grad, weight32],
                     dict(lr=lr, wd=wd, **kwargs))


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (``nag_mom_update``)."""

    def __init__(self, momentum=0.0, learning_rate=0.1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros(weight)
        return None

    def update(self, index, weight, grad, state):
        lr, wd, kwargs = _common(self, index)
        if state is not None:
            apply_op("nag_mom_update", [weight, grad, state],
                     dict(lr=lr, wd=wd, momentum=self.momentum, **kwargs))
        else:
            apply_op("sgd_update", [weight, grad], dict(lr=lr, wd=wd,
                                                        **kwargs))


@register
class Adam(Optimizer):
    """Adam (``adam_update``): wd as L2 on the gradient, the bias
    correction folded into lr on the host."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))  # mean, var

    def update(self, index, weight, grad, state):
        if self.lazy_update and _is_rsp(grad):
            return self._update_rsp(index, weight, grad, state)
        lr, wd, kwargs = _common(self, index)
        t = self._index_update_count[index]
        coef1 = 1. - self.beta1 ** t
        coef2 = 1. - self.beta2 ** t
        lr *= coef2 ** 0.5 / coef1
        mean, var = state
        apply_op("adam_update", [weight, grad, mean, var],
                 dict(lr=lr, wd=wd, beta1=self.beta1, beta2=self.beta2,
                      epsilon=self.epsilon, **kwargs))

    @_no_grad
    def _update_rsp(self, index, weight, grad, state):
        """Lazy Adam: only the gradient's rows advance their mean, var and
        weight (the reference's Adam._update_rsp)."""
        lr, wd, _ = _common(self, index)
        t = self._index_update_count[index]
        lr *= (1. - self.beta2 ** t) ** 0.5 / (1. - self.beta1 ** t)
        rows, g = _rsp_grad_rows(self, grad)
        mean, var = state
        wr = weight[rows]
        g = g.to(wr.dtype) + wd * wr
        mr = self.beta1 * mean[rows] + (1 - self.beta1) * g
        vr = self.beta2 * var[rows] + (1 - self.beta2) * g * g
        mean.index_copy_(0, rows, mr)
        var.index_copy_(0, rows, vr)
        weight.index_copy_(0, rows,
                           wr - lr * mr / (torch.sqrt(vr) + self.epsilon))


@register
class AdamW(Optimizer):
    """AdamW with decoupled weight decay (``_adamw_update``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, eta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.eta = eta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        lr, wd, kwargs = _common(self, index)
        t = self._index_update_count[index]
        coef1 = 1. - self.beta1 ** t
        coef2 = 1. - self.beta2 ** t
        lr *= coef2 ** 0.5 / coef1
        mean, var = state
        apply_op("_adamw_update", [weight, grad, mean, var],
                 dict(lr=lr, wd=wd, eta=self.eta, beta1=self.beta1,
                      beta2=self.beta2, epsilon=self.epsilon, **kwargs))


@register
class AdaGrad(Optimizer):
    """AdaGrad (``_adagrad_update``)."""

    def __init__(self, learning_rate=0.01, eps=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)  # history

    def update(self, index, weight, grad, state):
        lr, wd, kwargs = _common(self, index)
        apply_op("_adagrad_update", [weight, grad, state],
                 dict(lr=lr, wd=wd, epsilon=self.float_stable_eps, **kwargs))


@register
class RMSProp(Optimizer):
    """RMSProp, plain (``rmsprop_update``) or centered, Alex Graves's
    (``rmspropalex_update``)."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho = rho
        self.momentum = momentum
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return (_zeros(weight),)  # n

    def update(self, index, weight, grad, state):
        lr, wd, kwargs = _common(self, index)
        kwargs.update(rho=self.rho, epsilon=self.epsilon)
        if self.centered:
            kwargs["momentum"] = self.momentum
        if self.clip_weights:
            kwargs["clip_weights"] = self.clip_weights
        if not self.centered:
            (n,) = state
            apply_op("rmsprop_update", [weight, grad, n],
                     dict(lr=lr, wd=wd, **kwargs))
        else:
            n, g, delta = state
            apply_op("rmspropalex_update", [weight, grad, n, g, delta],
                     dict(lr=lr, wd=wd, **kwargs))


@register
class Ftrl(Optimizer):
    """FTRL (``ftrl_update``)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))  # z, n

    def update(self, index, weight, grad, state):
        lr, wd, kwargs = _common(self, index)
        z, n = state
        apply_op("ftrl_update", [weight, grad, z, n],
                 dict(lr=lr, wd=wd, lamda1=self.lamda1, beta=self.beta,
                      **kwargs))


@register
class Signum(Optimizer):
    """Signum: the sign of the momentum (``signum_update``; without
    momentum ``signsgd_update``)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros(weight)
        return None

    def update(self, index, weight, grad, state):
        lr, wd, kwargs = _common(self, index)
        if state is not None:
            apply_op("signum_update", [weight, grad, state],
                     dict(lr=lr, wd=wd, momentum=self.momentum,
                          wd_lh=self.wd_lh, **kwargs))
        else:
            apply_op("signsgd_update", [weight, grad],
                     dict(lr=lr, wd=wd, **kwargs))


@register
class SignSGD(Signum):
    """Momentum-free Signum."""

    def __init__(self, learning_rate=0.01, **kwargs):
        super().__init__(learning_rate=learning_rate, momentum=0.0, **kwargs)


# ------------------------------------------------ the reference's tail --
# Tensor arithmetic operation by operation in the reference's order; a
# division by a host scalar divides by a 0-d tensor (``_div``), exactly
# on either device.
@register
class AdaDelta(Optimizer):
    """AdaDelta."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))  # E[g^2], E[dx^2]

    @_no_grad
    def update(self, index, weight, grad, state):
        _, wd, _ = _common(self, index)
        grad = _dense(grad) * self.rescale_grad
        if self.clip_gradient is not None:
            grad = grad.clamp(-self.clip_gradient, self.clip_gradient)
        grad = grad + wd * weight
        acc_g, acc_delta = state
        acc_g.copy_(self.rho * acc_g + (1. - self.rho) * grad * grad)
        current_delta = ((acc_delta + self.epsilon).sqrt()
                         / (acc_g + self.epsilon).sqrt() * grad)
        acc_delta.copy_(self.rho * acc_delta
                        + (1. - self.rho) * current_delta * current_delta)
        weight.copy_(weight - current_delta)


@register
class Adamax(Optimizer):
    """AdaMax, Adam under the infinity norm."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))  # mean, u (inf-norm)

    @_no_grad
    def update(self, index, weight, grad, state):
        lr, wd, _ = _common(self, index)
        t = self._index_update_count[index]
        lr /= (1. - self.beta1 ** t)
        grad = _dense(grad) * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            grad = grad.clamp(-self.clip_gradient, self.clip_gradient)
        m_t, u_t = state
        m_t.copy_(self.beta1 * m_t + (1. - self.beta1) * grad)
        u_t.copy_(torch.maximum(self.beta2 * u_t, grad.abs()))
        weight.copy_(weight - lr * m_t / u_t)


@register
class Nadam(Optimizer):
    """Nesterov Adam; ``m_schedule`` (the product of the momentum
    schedule) lives on the optimizer, shared by its parameters, as in
    the reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @_no_grad
    def update(self, index, weight, grad, state):
        lr, wd, _ = _common(self, index)
        t = self._index_update_count[index]
        grad = _dense(grad) * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            grad = grad.clamp(-self.clip_gradient, self.clip_gradient)
        momentum_t = self.beta1 * (1. - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1. - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m_t, v_t = state
        m_t.copy_(self.beta1 * m_t + (1. - self.beta1) * grad)
        v_t.copy_(self.beta2 * v_t + (1. - self.beta2) * grad * grad)
        grad_prime = _div(grad, 1. - self.m_schedule)
        m_t_prime = _div(m_t, 1. - m_schedule_next)
        v_t_prime = _div(v_t, 1. - self.beta2 ** t)
        m_t_bar = ((1. - momentum_t) * grad_prime
                   + momentum_t_1 * m_t_prime)
        weight.copy_(weight - lr * m_t_bar / (v_t_prime.sqrt()
                                              + self.epsilon))


@register
class FTML(Optimizer):
    """FTML (Follow The Moving Leader), the reference class's arithmetic
    (not the ``ftml_update`` op)."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    @_no_grad
    def update(self, index, weight, grad, state):
        lr, wd, _ = _common(self, index)
        t = self._index_update_count[index]
        grad = _dense(grad) * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            grad = grad.clamp(-self.clip_gradient, self.clip_gradient)
        prev_d, prev_v, prev_z = state
        prev_v.copy_(self.beta2 * prev_v + (1. - self.beta2) * grad * grad)
        d_t = ((1. - self.beta1 ** t) / lr
               * (_div(prev_v, 1. - self.beta2 ** t).sqrt() + self.epsilon))
        sigma_t = d_t - self.beta1 * prev_d
        prev_z.copy_(self.beta1 * prev_z + (1. - self.beta1) * grad
                     - sigma_t * weight)
        weight.copy_(-prev_z / d_t)
        prev_d.copy_(d_t)


@register
class LAMB(Optimizer):
    """LAMB, layer-wise adaptive large-batch Adam: ``lamb_update_phase1``,
    the weight's and the step's norms (on the card, no host read), then
    ``lamb_update_phase2``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @_no_grad
    def update(self, index, weight, grad, state):
        lr, wd, kwargs = _common(self, index)
        t = self._index_update_count[index]
        mean, var = state
        g, new_mean, new_var = apply_op(
            "lamb_update_phase1", [weight, grad, mean, var],
            dict(beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                 t=t, bias_correction=self.bias_correction, wd=wd,
                 **kwargs))
        mean.copy_(new_mean)
        var.copy_(new_var)
        r1 = apply_op("norm", [weight])
        r2 = apply_op("norm", [g])
        phase2_kw = dict(lr=lr)
        if self.lower_bound:
            phase2_kw["lower_bound"] = self.lower_bound
        if self.upper_bound:
            phase2_kw["upper_bound"] = self.upper_bound
        apply_op("lamb_update_phase2", [weight, g, r1, r2], phase2_kw)


def _host_norm(x):
    """The L2 norm of ``x`` read on the host (a sync on the card)."""
    return float(apply_op("norm", [x]).item())


@register
class LARS(Optimizer):
    """LARS, layer-wise adaptive rate scaling; its trust ratio reads the
    weight's and the gradient's norms on the host."""

    def __init__(self, learning_rate=0.1, momentum=0.0, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros(weight)
        return None

    def update(self, index, weight, grad, state):
        lr, wd, kwargs = _common(self, index)
        grad = _dense(grad)
        w_norm = _host_norm(weight.detach())
        g_norm = _host_norm(grad * self.rescale_grad)
        if w_norm > 0.0 and g_norm > 0.0:
            lars_trust = self.eta * w_norm / (g_norm + wd * w_norm
                                              + self.epsilon)
        else:
            lars_trust = 1.0
        lr = lr * lars_trust
        if state is not None:
            apply_op("sgd_mom_update", [weight, grad, state],
                     dict(lr=lr, wd=wd, momentum=self.momentum, **kwargs))
        else:
            apply_op("sgd_update", [weight, grad], dict(lr=lr, wd=wd,
                                                        **kwargs))


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD; its state is (momentum or
    None, the previous weight)."""

    def __init__(self, momentum=0.0, lamda=0.04, learning_rate=0.01,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        prev = weight.detach().clone()
        if self.momentum == 0.0:
            return (None, prev)
        return (_zeros(weight), prev)

    @_no_grad
    def update(self, index, weight, grad, state):
        lr, wd, _ = _common(self, index)
        grad = _dense(grad) * self.rescale_grad
        if self.clip_gradient is not None:
            grad = grad.clamp(-self.clip_gradient, self.clip_gradient)
        mom, previous_weight = state
        delta = -lr * (grad + wd * weight + self.lamda * grad * grad
                       * (weight - previous_weight))
        if mom is not None:
            mom.copy_(self.momentum * mom + delta)
            step = mom
        else:
            step = delta
        previous_weight.copy_(weight)
        weight.copy_(weight + step)


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics: the SGD step plus
    N(0, lr) noise drawn through ``nd.random`` on the weight's device."""

    def __init__(self, learning_rate=0.1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)

    def create_state(self, index, weight):
        return None

    @_no_grad
    def update(self, index, weight, grad, state):
        from ..ndarray import random as nd_random
        lr, wd, _ = _common(self, index)
        grad = _dense(grad) * self.rescale_grad
        if self.clip_gradient is not None:
            grad = grad.clamp(-self.clip_gradient, self.clip_gradient)
        noise = nd_random.normal(0, math.sqrt(lr), shape=tuple(weight.shape),
                                 dtype=str(weight.dtype).replace("torch.",
                                                                 ""),
                                 ctx=weight.device)._data
        weight.copy_(weight - lr / 2 * (grad + wd * weight) + noise)


@register
class LBSGD(Optimizer):
    """Large-batch SGD with the reference's warmup strategies (linear,
    power2, sqrt) or, under ``warmup_strategy="lars"``, the LARS ratio
    (norms read on the host)."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 learning_rate=0.01, **kwargs):
        super().__init__(learning_rate=learning_rate,
                         multi_precision=multi_precision, **kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.lbmult = 1.0
        self.cumgrads = {}
        self.adaptive = False
        self.admult = 1.0

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def _get_lbmult(self, nup):
        nwup = self.warmup_epochs * self.updates_per_epoch
        strategy = self.warmup_strategy
        maxmult = float(self.batch_scale)
        if nup >= nwup:
            mult = maxmult
        elif nwup <= 1:
            mult = 1.0
        elif strategy == "linear":
            mult = 1.0 + (maxmult - 1) * nup / nwup
        elif strategy == "power2":
            mult = 1.0 + (maxmult - 1) * (nup * nup) / (nwup * nwup)
        elif strategy == "sqrt":
            mult = 1.0 + (maxmult - 1) * math.sqrt(float(nup) / nwup)
        else:
            mult = 1.0
        return mult

    def update(self, index, weight, grad, state):
        lr, wd, kwargs = _common(self, index)
        grad = _dense(grad)
        if self.warmup_strategy == "lars":
            w_norm = _host_norm(weight.detach())
            g_norm = _host_norm(grad * self.rescale_grad)
            if w_norm > 0 and g_norm > 0:
                lbmult = w_norm / (g_norm + wd * w_norm + 1e-9)
            else:
                lbmult = 1.0
            lr = lr * lbmult
        else:
            lr = lr * self._get_lbmult(self.num_update)
        if state is not None:
            apply_op("sgd_mom_update", [weight, grad, state],
                     dict(lr=lr, wd=wd, momentum=self.momentum, **kwargs))
        else:
            apply_op("sgd_update", [weight, grad], dict(lr=lr, wd=wd,
                                                        **kwargs))


@register
class GroupAdaGrad(Optimizer):
    """AdaGrad with one history value a row (the mean of the row's
    squared gradient); no weight decay."""

    def __init__(self, learning_rate=0.01, eps=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return torch.zeros((weight.shape[0],) + (1,) * (weight.ndim - 1),
                           dtype=weight.dtype, device=weight.device)

    @_no_grad
    def update(self, index, weight, grad, state):
        lr, wd, _ = _common(self, index)
        assert wd == 0, "Weight decay is not supported for GroupAdaGrad"
        grad = _dense(grad) * self.rescale_grad
        if self.clip_gradient is not None:
            grad = grad.clamp(-self.clip_gradient, self.clip_gradient)
        axes = tuple(range(1, grad.ndim))
        sq = grad * grad
        # a vector's rows are its elements (torch's mean over no dims
        # would reduce them all)
        state.copy_(state + (sq.mean(dim=axes, keepdim=True) if axes
                             else sq))
        weight.copy_(weight - lr * grad / (state + self.float_stable_eps)
                     .sqrt())


@register
class Test(Optimizer):
    """The reference's test optimizer: ``w -= lr * (grad * rescale_grad +
    wd * w)``, no update count."""

    def __init__(self, learning_rate=0.01, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)

    def create_state(self, index, weight):
        return _zeros(weight)

    @_no_grad
    def update(self, index, weight, grad, state):
        weight.copy_(weight - self.lr * (_dense(grad) * self.rescale_grad
                                         + self.wd * weight))

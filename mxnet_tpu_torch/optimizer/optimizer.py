"""Optimizers of the port (mirrors ``mxnet_tpu/optimizer/optimizer.py``):
the ``Optimizer`` base with MXNet's bookkeeping and the nine optimizers
whose update is one registered update op (``fused.py``'s fusable set):
SGD (momentum, ``multi_precision`` through ``mp_sgd_*``), NAG, Adam,
AdamW, AdaGrad, RMSProp (plain and centered), Ftrl, Signum and SignSGD.

Each ``update`` runs its op through :func:`~mxnet_tpu_torch.ops.invoke.
apply_op` (``ops/optimizer_ops.py``), which writes the weight and the
states in place: the twin on the CPU, the multi-tensor kernel on the
card. The rules are MXNet's, not ``torch.optim``'s: Adam folds the bias
correction into the learning rate on the host, ``lr * sqrt(1 - beta2^t)
/ (1 - beta1^t)``, and adds ``epsilon`` to ``sqrt(v)`` of the
uncorrected ``v``; the gradient is ``grad * rescale_grad``, clipped to
``+-clip_gradient``; ``t`` is counted per parameter index; ``lr_mult``/
``wd_mult`` come from the Parameter (``param_dict``), the per-index or
the per-name tables. All of it runs on the host in float64.

The reference's other optimizers (AdaDelta, Adamax, Nadam, FTML, LAMB,
LARS, DCASGD, SGLD, LBSGD, GroupAdaGrad) and its lazy row-sparse updates
are not ported yet (ROADMAP.md §1 item 13).
"""
from __future__ import annotations

import torch

from ..ops.invoke import apply_op

__all__ = ["Optimizer", "register", "create", "SGD", "NAG", "Adam", "AdamW",
           "AdaGrad", "RMSProp", "Ftrl", "Signum", "SignSGD"]

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
        lr, wd, kwargs = _common(self, index)
        if state is not None:
            apply_op("sgd_mom_update", [weight, grad, state],
                     dict(lr=lr, wd=wd, momentum=self.momentum, **kwargs))
        else:
            apply_op("sgd_update", [weight, grad], dict(lr=lr, wd=wd,
                                                        **kwargs))

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
        lr, wd, kwargs = _common(self, index)
        t = self._index_update_count[index]
        coef1 = 1. - self.beta1 ** t
        coef2 = 1. - self.beta2 ** t
        lr *= coef2 ** 0.5 / coef1
        mean, var = state
        apply_op("adam_update", [weight, grad, mean, var],
                 dict(lr=lr, wd=wd, beta1=self.beta1, beta2=self.beta2,
                      epsilon=self.epsilon, **kwargs))


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

"""Optimizers of the port (mirrors ``mxnet_tpu/optimizer/optimizer.py``):
the ``Optimizer`` base with MXNet's bookkeeping, ``Adam`` and ``AdamW``.

The update rules are MXNet's (``mxnet_tpu/ops/optimizer_ops.py``
``adam_update`` / ``_adamw_update``), not ``torch.optim``'s:

- Adam folds the bias correction into the learning rate on the host,
  ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)``, and adds ``epsilon`` to
  ``sqrt(v)`` of the uncorrected ``v``;
- the gradient is ``grad * rescale_grad``, clipped to
  ``+-clip_gradient``, and Adam then adds ``wd * weight`` to it (L2);
  AdamW decays the weight apart from the gradient (``eta * wd * w``);
- ``t`` is counted per parameter index; ``lr_mult``/``wd_mult`` come from
  the Parameter (``param_dict``) or the per-index tables.

Updates are in place on the parameter tensors, under ``no_grad``.
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer", "register", "create", "Adam", "AdamW"]


class Optimizer:
    """Base optimizer."""

    opt_registry = {}

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.lr_mult = {}
        self.wd_mult = {}
        self.num_update = 0
        self._index_update_count = {}
        self.param_dict = param_dict if param_dict else {}

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError(f"Cannot find optimizer {name}")

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def _update_count(self, index):
        self._index_update_count[index] = \
            self._index_update_count.get(index, 0) + 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        if index in self.param_dict:
            return self.lr * self.param_dict[index].lr_mult
        return self.lr * self.lr_mult.get(index, 1.0)

    def _get_wd(self, index):
        if index in self.param_dict:
            return self.wd * self.param_dict[index].wd_mult
        return self.wd * self.wd_mult.get(index, 1.0)

    def _common(self, index):
        """(lr, wd) for one parameter update; counts the update."""
        self._update_count(index)
        return self._get_lr(index), self._get_wd(index)

    def _prep(self, grad):
        """``grad * rescale_grad``, clipped to ``+-clip_gradient``."""
        g = grad * self.rescale_grad
        if self.clip_gradient is not None and self.clip_gradient >= 0:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return g


register = Optimizer.register
create = Optimizer.create_optimizer


class _AdamBase(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def _moments(self, index, g, state):
        """Advance (mean, var) with ``g``; returns the bias-corrected lr
        times ``mean / (sqrt(var) + epsilon)``, and wd."""
        lr, wd = self._common(index)
        t = self._index_update_count[index]
        lr *= (1. - self.beta2 ** t) ** 0.5 / (1. - self.beta1 ** t)
        mean, var = state
        mean.mul_(self.beta1).add_((1 - self.beta1) * g)
        var.mul_(self.beta2).add_((1 - self.beta2) * g.square())
        return lr * mean / (var.sqrt() + self.epsilon), wd


@register
class Adam(_AdamBase):
    """Adam with MXNet's rule (``adam_update``): wd as L2 on the
    gradient."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        wd = self._get_wd(index)
        step, _ = self._moments(index, self._prep(grad) + wd * weight, state)
        weight.sub_(step)


@register
class AdamW(_AdamBase):
    """AdamW with decoupled weight decay (``_adamw_update``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, eta=1.0, **kwargs):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kwargs)
        self.eta = eta

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        step, wd = self._moments(index, self._prep(grad), state)
        weight.sub_(self.eta * (step + wd * weight))

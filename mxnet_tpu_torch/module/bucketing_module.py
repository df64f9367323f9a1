"""BucketingModule: variable-length sequence training (a copy of
``mxnet_tpu/module/bucketing_module.py``).

Reference: python/mxnet/module/bucketing_module.py — one Module per
bucket key, shared parameters: each bucket binds its own executor at
its shapes, and the buckets share the default bucket's parameter
arrays.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    """Bucketed modules with shared params (reference:
    bucketing_module.py:39)."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._init_args = None

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def symbol(self):
        return self._curr_module.symbol

    def _gen_module(self, bucket_key):
        if bucket_key in self._buckets:
            return self._buckets[bucket_key]
        sym, data_names, label_names = self._sym_gen(bucket_key)
        mod = Module(sym, data_names, label_names, logger=self.logger,
                     context=self._context,
                     fixed_param_names=self._fixed_param_names)
        self._buckets[bucket_key] = mod
        return mod

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        mod = self._gen_module(self._default_bucket_key)
        mod.bind(data_shapes, label_shapes, for_training,
                 inputs_need_grad, force_rebind=False, grad_req=grad_req)
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Switch current bucket (reference: bucketing_module.py:404).

        Parameter STORAGE is shared: the new bucket's executor aliases the
        default module's parameter NDArray objects (updates rebind the
        shared object's buffer), reproducing the reference's
        ``shared_module`` bind semantics without copies."""
        assert self.binded, "call bind before switching bucket"
        mod = self._gen_module(bucket_key)
        if not mod.binded:
            mod.bind(data_shapes, label_shapes, self.for_training)
            owner = self._buckets[self._default_bucket_key]
            for name in mod._param_names:
                if name not in owner._exec.arg_dict:
                    raise RuntimeError(
                        f"Parameter '{name}' of bucket {bucket_key!r} is "
                        "not present in the default bucket's symbol; the "
                        "default_bucket_key symbol must carry the full "
                        "parameter set (reference: bucketing_module.py "
                        "shared_module bind)")
                mod._exec.arg_dict[name] = owner._exec.arg_dict[name]
            for name in mod._aux_names:
                if name in owner._exec.aux_dict:
                    mod._exec.aux_dict[name] = owner._exec.aux_dict[name]
            if self._curr_module.optimizer_initialized:
                mod._optimizer = self._curr_module._optimizer
                mod._updater = self._curr_module._updater
                mod.optimizer_initialized = True
        # flag sync every switch: init_params() may have run since this
        # bucket was bound (storage is aliased, so the arrays are current)
        mod.params_initialized = self.params_initialized
        self._curr_module = mod
        self._curr_bucket_key = bucket_key

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        # initialize through the default bucket (the storage owner); all
        # other bound buckets alias the same arrays — just sync their flags
        owner = self._buckets[self._default_bucket_key]
        owner.init_params(initializer, arg_params, aux_params,
                          allow_missing, force_init, allow_extra)
        self.params_initialized = True
        for mod in self._buckets.values():
            if mod.binded:
                mod.params_initialized = True

    def get_params(self):
        # sync the default module with the latest trained params
        return self._curr_module.get_params()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._curr_module.init_optimizer(kvstore, optimizer,
                                         optimizer_params, force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module and mod.binded:
                mod._optimizer = self._curr_module._optimizer
                mod._updater = self._curr_module._updater
                mod.optimizer_initialized = True
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded
        key = data_batch.bucket_key
        if key is None:
            key = self._default_bucket_key
        if key != self._curr_bucket_key:
            # param storage is aliased across buckets (switch_bucket), so
            # no carry-over copy is needed
            self.switch_bucket(key, data_batch.provide_data,
                               data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        for mod in self._buckets.values():
            if mod.binded:
                mod.install_monitor(mon)

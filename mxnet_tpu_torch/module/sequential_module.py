"""SequentialModule: chain multiple modules end to end (a copy of
``mxnet_tpu/module/sequential_module.py``).

Reference: python/mxnet/module/sequential_module.py:28. Same meta-key
protocol: ``add(module, take_labels=True, auto_wiring=True)`` —
``take_labels`` feeds the chain's labels to that module, ``auto_wiring``
derives the module's data shapes from the previous module's outputs at
bind time. forward runs the chain left to right; backward right to
left, handing each module's input gradients to its predecessor (every
non-head module is bound with ``inputs_need_grad=True``).
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from ..io.io import DataBatch, DataDesc

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None
        self._meta_keys = {getattr(SequentialModule, x)
                           for x in dir(SequentialModule)
                           if x.startswith("META_")}

    def add(self, module, **kwargs):
        """Append a module (reference: sequential_module.py:52).
        Returns self so calls chain."""
        for key in kwargs:
            assert key in self._meta_keys, \
                f"Unknown meta '{key}', a typo? allowed: {self._meta_keys}"
        self._modules.append(module)
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    # ---------------------------------------------------------- binding --
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        assert len(self._modules) > 0, "add modules first"
        assert shared_module is None, \
            "shared_module is not supported by SequentialModule"
        self.for_training = for_training
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes

        my_shapes = data_shapes
        for i, (module, meta) in enumerate(zip(self._modules,
                                               self._metas)):
            take = meta.get(self.META_TAKE_LABELS, False)
            module.bind(
                data_shapes=my_shapes,
                label_shapes=label_shapes if take else None,
                for_training=for_training,
                inputs_need_grad=(i > 0 or inputs_need_grad),
                force_rebind=force_rebind, grad_req=grad_req)
            # auto-wire: next module's data = this module's output shapes,
            # from symbol shape inference (executor outputs only exist
            # after the first forward)
            if hasattr(module, "symbol") and module.symbol is not None:
                feed = {d.name if isinstance(d, DataDesc) else d[0]:
                        tuple(d.shape if isinstance(d, DataDesc) else d[1])
                        for d in my_shapes}
                if take and label_shapes:
                    for d in label_shapes:
                        name, shape = (d.name, d.shape) \
                            if isinstance(d, DataDesc) else (d[0], d[1])
                        feed.setdefault(name, tuple(shape))
                _, shapes, _ = module.symbol.infer_shape(**feed)
            else:
                shapes = module.output_shapes
            my_shapes = [DataDesc(f"data{j}" if len(shapes) > 1 else
                                  "data", tuple(s))
                         for j, s in enumerate(shapes)]
        self.binded = True

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        for module in self._modules:
            module.init_params(initializer=initializer,
                               arg_params=arg_params,
                               aux_params=aux_params,
                               allow_missing=True,
                               force_init=force_init,
                               allow_extra=True)
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    # ---------------------------------------------------------- running --
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        batch = DataBatch(data=data_batch.data, label=data_batch.label)
        for module, meta in zip(self._modules, self._metas):
            module.forward(batch, is_train=is_train)
            batch = DataBatch(data=module.get_outputs(),
                              label=data_batch.label)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for module in reversed(self._modules):
            module.backward(out_grads=out_grads)
            out_grads = module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[0].get_input_grads(merge_multi_context)

    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        for module in self._modules:
            module.set_params(arg_params, aux_params, allow_missing=True,
                              force_init=force_init, allow_extra=True)
        self.params_initialized = True

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        took = False
        for module, meta in zip(self._modules, self._metas):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels, pre_sliced)
                took = True
        if not took:
            # default: score against the chain's final outputs
            eval_metric.update(labels, self.get_outputs())

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

"""PythonModule / PythonLossModule: modules implemented in Python (a copy
of ``mxnet_tpu/module/python_module.py``).

Reference: python/mxnet/module/python_module.py:28 (PythonModule — a
parameterless module whose compute is written directly in Python/numpy)
and :243 (PythonLossModule — a head module that turns scores into a
loss gradient for the chain below it). These are host-side
escape hatches, like the reference's: compute runs eagerly on NDArray
(which dispatches to the device), no executor involved.
"""
from __future__ import annotations

import logging

import numpy as _np

from .base_module import BaseModule
from ..ndarray import NDArray

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Subclass and override ``forward``/``backward`` (or
    ``_compute_output_shapes`` for shape inference only)."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # ------------------------------------------------------- lifecycle --
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        """Default: outputs mirror the data shapes (reference:
        python_module.py:150). Override for different output shapes."""
        return [tuple(d[1] if isinstance(d, tuple) else d.shape)
                for d in self._data_shapes]

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        # parameterless by definition (reference: python_module.py:106)
        self.params_initialized = True

    def init_optimizer(self, *args, **kwargs):
        self.optimizer_initialized = True

    def get_params(self):
        return {}, {}

    def set_params(self, arg_params, aux_params, **kwargs):
        pass

    def update(self):
        pass

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self.get_outputs())

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes


class PythonLossModule(PythonModule):
    """Head module computing a loss gradient in Python (reference:
    python_module.py:243). ``grad_func(scores, labels) -> grad`` defines
    the backward; the default is cross-entropy-style ``scores - onehot``
    left to the user via grad_func.
    """

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names,
                         [name + "_output"], logger=logger)
        self._name = name
        self._scores = None
        self._labels = None
        self._scores_grad = None
        self._grad_func = grad_func

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if data_batch.label is not None and len(data_batch.label):
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, \
            "PythonLossModule is a loss head; it takes no out_grads"
        assert self.for_training
        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
            if not isinstance(grad, NDArray):
                grad = NDArray(_np.asarray(grad), ctx=self._scores.context)
            self._scores_grad = grad
        else:
            raise NotImplementedError(
                "provide grad_func(scores, labels) -> grad")

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()

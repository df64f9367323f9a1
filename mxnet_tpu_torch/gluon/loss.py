"""Loss blocks of the port (mirrors ``mxnet_tpu/gluon/loss.py``): the base
``Loss``, ``L2Loss`` and ``SoftmaxCrossEntropyLoss``. A loss returns one
value per sample: the mean over every axis but ``batch_axis``."""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        if not isinstance(weight, (int, float)):
            raise TypeError("weight must be a number")
        loss = loss * weight
    return loss


def _mean_except(loss, batch_axis):
    axes = [a for a in range(loss.ndim) if a != batch_axis % loss.ndim]
    return loss.mean(dim=axes) if axes else loss


class Loss(HybridBlock):
    """Base loss: a scalar ``weight`` and the ``batch_axis`` kept."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis


class L2Loss(Loss):
    """``weight / 2 * (pred - label) ** 2``, the label reshaped to the
    prediction's shape."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).square()
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _mean_except(loss, self._batch_axis)


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross entropy; ``sparse_label`` takes class indices (float
    or integer), otherwise a distribution over classes."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = label.reshape(pred.shape)
            loss = -(pred * label).sum(dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_except(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss

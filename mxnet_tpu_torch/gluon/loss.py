"""Loss blocks of the port (mirrors ``mxnet_tpu/gluon/loss.py``): the
reference's fifteen — L2, L1, sigmoid binary cross-entropy, softmax
cross-entropy, KL divergence, CTC, Huber, hinge, squared hinge,
logistic, triplet, Poisson NLL, cosine embedding and SDML. A loss
returns one value per sample: the mean over every axis but
``batch_axis`` (``TripletLoss`` sums them, ``CTCLoss`` returns the
sequence loss, ``PoissonNLLLoss`` the mean over everything), scaled by a
scalar ``weight`` and a broadcast ``sample_weight``; torch's autograd
gives the gradients."""
from __future__ import annotations

import math

import torch

from ..ops.elemwise import relu
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss", "SDMLLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        if not isinstance(weight, (int, float)):
            raise TypeError("weight must be a number")
        loss = loss * weight
    return loss


def _reshape_like(x, y):
    return x.reshape(y.shape)


def _mean_except(loss, batch_axis):
    axes = [a for a in range(loss.ndim) if a != batch_axis % loss.ndim]
    return loss.mean(dim=axes) if axes else loss


def _softrelu(F, x):
    return F.Activation(x, act_type="softrelu")


class Loss(HybridBlock):
    """Base loss: a scalar ``weight`` and the ``batch_axis`` kept."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{self.__class__.__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")


class L2Loss(Loss):
    """``weight / 2 * (pred - label) ** 2``, the label reshaped to the
    prediction's shape."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = (_reshape_like(label, pred) - pred).square()
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _mean_except(loss, self._batch_axis)


class L1Loss(Loss):
    """``|pred - label|``."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = (_reshape_like(label, pred) - pred).abs()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_except(loss, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of logits (the stable ``max(x, 0) - x z +
    log(1 + exp(-|x|))``) or, ``from_sigmoid``, of probabilities;
    ``pos_weight`` scales the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _reshape_like(label, pred)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = relu(pred) - pred * label + \
                    _softrelu(F, -pred.abs())
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    _softrelu(F, -pred.abs()) + relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label
                         + torch.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight
                         + torch.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_except(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


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
            label = _reshape_like(label, pred)
            loss = -(pred * label).sum(dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_except(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label) - pred)``; ``pred`` log-probabilities
    (``from_logits``), else logits put through ``log_softmax``."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_except(loss, self._batch_axis)


class CTCLoss(Loss):
    """Connectionist temporal classification through the registry's
    ``CTCLoss`` op: ``pred`` in ``layout`` (``NTC`` or ``TNC``), labels in
    ``label_layout`` padded with -1, the blank the last class."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise ValueError(f"layout must be NTC or TNC, got {layout}")
        if label_layout not in ("NT", "TN"):
            raise ValueError(
                f"label_layout must be NT or TN, got {label_layout}")
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._batch_axis == 1:
            label = label.transpose(0, 1)
        inputs = [pred, label]
        if pred_lengths is not None or label_lengths is not None:
            T, N = pred.shape[0], pred.shape[1]
            inputs.append(pred_lengths if pred_lengths is not None else
                          torch.full((N,), T, device=pred.device))
        if label_lengths is not None:
            inputs.append(label_lengths)
        loss = F.CTCLoss(*inputs, use_data_lengths=pred_lengths is not None,
                         use_label_lengths=label_lengths is not None,
                         blank_label="last")
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """Smoothed L1: ``|d| - rho/2`` above ``rho``, ``d^2 / (2 rho)``
    below."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = (_reshape_like(label, pred) - pred).abs()
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * loss.square())
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_except(loss, self._batch_axis)


class HingeLoss(Loss):
    """``max(0, margin - pred * label)``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = relu(self._margin - pred * _reshape_like(label, pred))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_except(loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    """``max(0, margin - pred * label) ** 2``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = relu(self._margin - pred * _reshape_like(label, pred)
                    ).square()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_except(loss, self._batch_axis)


class LogisticLoss(Loss):
    """``log(1 + exp(-pred * label))`` of ``signed`` (-1/1) or
    ``binary`` (0/1) labels."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format
        if label_format not in ("signed", "binary"):
            raise ValueError(f"label_format can only be signed or binary, "
                             f"got {label_format}")

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = relu(pred) - pred * label + _softrelu(F, -pred.abs())
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_except(loss, self._batch_axis)


class TripletLoss(Loss):
    """``max(|pred - positive|^2 - |pred - negative|^2 + margin, 0)``, the
    squares summed over every axis but ``batch_axis``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        positive = _reshape_like(positive, pred)
        negative = _reshape_like(negative, pred)
        diff = (positive - pred).square() - (negative - pred).square()
        axes = [a for a in range(diff.ndim)
                if a != self._batch_axis % diff.ndim]
        loss = relu(diff.sum(dim=axes) + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood of log-rates (``from_logits``) or
    rates, ``compute_full`` adding Stirling's term where the target
    exceeds 1; the mean over every element."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        target = _reshape_like(target, pred)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = target * torch.log(target + 1e-12) - target + \
                0.5 * torch.log(2 * target * math.pi + 1e-12)
            stirling = torch.where(target <= 1, torch.zeros_like(stirling),
                                   stirling)
            loss = loss + stirling
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    """``1 - cos(input1, input2)`` where ``label`` is 1, else
    ``max(0, cos - margin)``; the norms' product floored at 1e-12."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        input1 = _reshape_like(input1, input2)
        cos_sim = self._cosine_similarity(input1, input2)
        label = label.reshape(-1, 1)
        loss = torch.where(label == 1, 1 - cos_sim,
                           relu(cos_sim - self._margin))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_except(loss, self._batch_axis)

    @staticmethod
    def _cosine_similarity(x, y, axis=-1):
        x_norm = x.square().sum(dim=axis).sqrt().reshape(-1, 1)
        y_norm = y.square().sum(dim=axis).sqrt().reshape(-1, 1)
        xy = (x * y).sum(dim=axis).reshape(-1, 1)
        return xy / torch.clamp(x_norm * y_norm, min=1e-12)


class SDMLLoss(Loss):
    """Smoothed deep metric learning: the KL divergence between the
    softmax of the negative squared distances of every (x1, x2) pair in
    the batch and the in-batch labels (1 - ``smoothing_parameter`` on the
    diagonal, the rest spread evenly), times the batch size."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self.kl_loss = KLDivLoss(from_logits=True)
        self.smoothing_parameter = smoothing_parameter

    @staticmethod
    def _compute_distances(x1, x2):
        return (x1[:, None, :] - x2[None, :, :]).square().sum(dim=2)

    def _compute_labels(self, batch_size, device):
        gold = torch.eye(batch_size, dtype=torch.float64)
        labels = gold * (1 - self.smoothing_parameter) + \
            (1 - gold) * self.smoothing_parameter / (batch_size - 1)
        return labels.to(device=device, dtype=torch.float32)

    def hybrid_forward(self, F, x1, x2):
        batch_size = x1.shape[0]
        labels = self._compute_labels(batch_size, x1.device)
        distances = self._compute_distances(x1, x2)
        log_probabilities = F.log_softmax(-distances, axis=1)
        return self.kl_loss(log_probabilities, labels) * batch_size

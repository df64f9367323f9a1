"""Evaluation metrics of the port (a copy of ``mxnet_tpu/metric.py``,
for ``mx.metric``).

Reference: python/mxnet/metric.py — the EvalMetric zoo (Accuracy,
TopKAccuracy, F1, MCC, Perplexity, MAE/MSE/RMSE, CrossEntropy, NLL, Pearson,
Loss, CustomMetric, CompositeEvalMetric, the VOC mAP metrics) plus the
string registry used by ``Module.fit(eval_metric="acc")``. The arithmetic
is the reference's, on host numpy: each ``update`` reads its inputs back
to the host (:func:`_as_numpy`), a blocking copy for a tensor on the card.
"""
from __future__ import annotations

import math
import sys
from collections import OrderedDict

import numpy

from .base import MXNetError

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss",
           "CustomMetric", "np", "create", "register"]

_METRIC_REGISTRY = {}


def register(klass, *names):
    key_names = names or (klass.__name__,)
    for name in key_names:
        _METRIC_REGISTRY[name.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    """Create by name / callable / list (reference: metric.py create)."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, CompositeEvalMetric):
        return metric
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite_metric = CompositeEvalMetric()
        for child_metric in metric:
            composite_metric.add(create(child_metric, *args, **kwargs))
        return composite_metric
    if isinstance(metric, str):
        try:
            return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)
        except KeyError:
            raise ValueError(f"Metric must be either callable or in registry; "
                             f"got {metric}")
    raise TypeError(f"metric should be str/callable/EvalMetric, got "
                    f"{type(metric)}")


def _as_numpy(x):
    """A host numpy copy of a port ``NDArray``, a ``torch.Tensor`` on
    either device, or anything ``numpy.asarray`` takes. A bfloat16 or
    float16 tensor is widened to float32 first: numpy has no bfloat16,
    every bf16/f16 value is exact in f32, so argmax and comparisons come
    out the same, and the sums are the reference's float32/float64 ones."""
    x = getattr(x, "_data", x)          # NDArray -> its tensor
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.cpu().numpy()
    return numpy.asarray(x)


def _is_array(x):
    """An array-like the metrics read as one output (not a list of
    them)."""
    torch = sys.modules.get("torch")
    return hasattr(x, "asnumpy") or isinstance(x, numpy.ndarray) or (
        torch is not None and isinstance(x, torch.Tensor))


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Reference: metric.py:36 check_label_shapes."""
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(f"Shape of labels {label_shape} does not match "
                         f"shape of predictions {pred_shape}")
    if wrap:
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
    return labels, preds


class EvalMetric:
    """Base metric (reference: metric.py:59)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"

    def get_config(self):
        config = self._kwargs.copy()
        config.update({"metric": self.__class__.__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    def _accum(self, value, n=1):
        """Add ``value`` over ``n`` instances to both the epoch-local and
        the global (reset_local-surviving) tallies."""
        self.sum_metric += value
        self.global_sum_metric += value
        self.num_inst += n
        self.global_num_inst += n

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.global_sum_metric / self.global_num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def get_global_name_value(self):
        name, value = self.get_global()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


class CompositeEvalMetric(EvalMetric):
    """Manage multiple metrics as one (reference: metric.py:298)."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        if metrics is None:
            metrics = []
        self.metrics = [create(i) for i in metrics]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError(f"Metric index {index} is out of range 0 and "
                              f"{len(self.metrics)}")

    @staticmethod
    def _restrict(d, names):
        if names is None:
            return d
        return OrderedDict((k, v) for k, v in d.items() if k in names)

    def update_dict(self, labels, preds):
        labels = self._restrict(labels, self.label_names)
        preds = self._restrict(preds, self.output_names)
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        try:
            for metric in self.metrics:
                metric.reset()
        except AttributeError:
            pass

    def reset_local(self):
        try:
            for metric in self.metrics:
                metric.reset_local()
        except AttributeError:
            pass

    def get(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int, numpy.generic)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)

    def get_global(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get_global()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int, numpy.generic)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)

    def get_config(self):
        config = super().get_config()
        config.update({"metrics": [i.get_config() for i in self.metrics]})
        return config


@register
class Accuracy(EvalMetric):
    """Classification accuracy (reference: metric.py:386)."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred_label in zip(labels, preds):
            pred_np = _as_numpy(pred_label)
            label_np = _as_numpy(label)
            if pred_np.shape != label_np.shape:
                pred_np = numpy.argmax(pred_np, axis=self.axis)
            pred_np = pred_np.astype("int32").flatten()
            label_np = label_np.astype("int32").flatten()
            check_label_shapes(label_np, pred_np)
            num_correct = (pred_np == label_np).sum()
            self.sum_metric += num_correct
            self.global_sum_metric += num_correct
            self.num_inst += len(pred_np)
            self.global_num_inst += len(pred_np)


_METRIC_REGISTRY["acc"] = Accuracy


@register
class TopKAccuracy(EvalMetric):
    """Top-k accuracy (reference: metric.py:462)."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, top_k=top_k, output_names=output_names,
                         label_names=label_names)
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += f"_{self.top_k}"

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred_label in zip(labels, preds):
            assert len(pred_label.shape) <= 2, \
                "Predictions should be no more than 2 dims"
            pred_np = _as_numpy(pred_label).astype("float32")
            num_dims = len(pred_np.shape)
            if num_dims == 2:
                pred_np = numpy.argsort(pred_np, axis=1)
            label_np = _as_numpy(label).astype("int32")
            num_samples = pred_np.shape[0]
            if num_dims == 1:
                num_correct = (pred_np.flatten() == label_np.flatten()).sum()
                self.sum_metric += num_correct
                self.global_sum_metric += num_correct
            elif num_dims == 2:
                num_classes = pred_np.shape[1]
                top_k = min(num_classes, self.top_k)
                for j in range(top_k):
                    num_correct = (pred_np[:, num_classes - 1 - j].flatten()
                                   == label_np.flatten()).sum()
                    self.sum_metric += num_correct
                    self.global_sum_metric += num_correct
            self.num_inst += num_samples
            self.global_num_inst += num_samples


_METRIC_REGISTRY["top_k_accuracy"] = TopKAccuracy
_METRIC_REGISTRY["top_k_acc"] = TopKAccuracy


class _BinaryClassificationMetrics:
    """Confusion bookkeeping shared by F1/MCC.

    Where the reference (metric.py:576) maintains eight scalar counters,
    the epoch-local and global tallies here are two 2x2 arrays indexed
    ``[label, prediction]`` — one vectorised bincount per batch updates
    the whole table, and every derived statistic reads off it."""

    def __init__(self):
        self._local = numpy.zeros((2, 2), numpy.int64)
        self._global = numpy.zeros((2, 2), numpy.int64)

    def update_binary_stats(self, label, pred):
        pred_np = _as_numpy(pred)
        label_np = _as_numpy(label).astype("int32")
        check_label_shapes(label_np, pred_np)
        if len(numpy.unique(label_np)) > 2:
            raise ValueError("%s currently only supports binary "
                             "classification." % self.__class__.__name__)
        # collapse to {0,1}: class-1 is "positive", everything else
        # (including argmax hits on extra columns) is "negative"
        is_pos = (numpy.argmax(pred_np, axis=1).ravel() == 1)
        truth = (label_np.ravel() == 1)
        delta = numpy.bincount(2 * truth + is_pos,
                               minlength=4).reshape(2, 2)
        self._local += delta
        self._global += delta

    @staticmethod
    def _prf(conf):
        """(precision, recall, fscore) of a 2x2 [label, pred] table."""
        tp = conf[1, 1]
        prec = tp / conf[:, 1].sum() if conf[:, 1].any() else 0.0
        rec = tp / conf[1, :].sum() if conf[1, :].any() else 0.0
        f = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
        return float(prec), float(rec), float(f)

    @property
    def precision(self):
        return self._prf(self._local)[0]

    @property
    def recall(self):
        return self._prf(self._local)[1]

    @property
    def fscore(self):
        return self._prf(self._local)[2]

    @property
    def global_fscore(self):
        return self._prf(self._global)[2]

    def matthewscc(self, use_global=False):
        conf = self._global if use_global else self._local
        if not conf.any():
            return 0.0
        ((tn, fp), (fn, tp)) = conf.astype(numpy.float64)
        # product of the four marginals, with empty marginals dropped
        # (the reference's convention, metric.py:876) rather than the
        # textbook 0-denominator
        marginals = numpy.asarray([tp + fp, tp + fn, tn + fp, tn + fn])
        denom = marginals[marginals != 0].prod()
        return (tp * tn - fp * fn) / math.sqrt(denom)

    @property
    def total_examples(self):
        return int(self._local.sum())

    @property
    def global_total_examples(self):
        return int(self._global.sum())

    def reset_stats(self):
        self._local[:] = 0

    def reset(self):
        self._local[:] = 0
        self._global[:] = 0


@register
class F1(EvalMetric):
    """Binary F1 (reference: metric.py:714)."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self.metrics = _BinaryClassificationMetrics()
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(label, pred)
        if self.average == "macro":
            self.sum_metric += self.metrics.fscore
            self.global_sum_metric += self.metrics.fscore
            self.num_inst += 1
            self.global_num_inst += 1
            self.metrics.reset_stats()
        else:
            self.sum_metric = self.metrics.fscore * self.metrics.total_examples
            self.global_sum_metric = (self.metrics.global_fscore
                                      * self.metrics.global_total_examples)
            self.num_inst = self.metrics.total_examples
            self.global_num_inst = self.metrics.global_total_examples

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0
        self.metrics.reset()

    def reset_local(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        self.metrics.reset_stats()


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient (reference: metric.py:811)."""

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        self._average = average
        self._metrics = _BinaryClassificationMetrics()
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        stats = self._metrics
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            stats.update_binary_stats(label, pred)
        if self._average == "macro":
            # one coefficient sample per update() call: the local table
            # restarts, the global one keeps accumulating
            self.sum_metric += stats.matthewscc()
            self.num_inst += 1
            self.global_sum_metric += stats.matthewscc(use_global=True)
            self.global_num_inst += 1
            stats.reset_stats()
        else:
            # micro: one coefficient over every example seen, expressed
            # as sum/count so get() recovers it unchanged
            self.sum_metric = stats.matthewscc() * stats.total_examples
            self.num_inst = stats.total_examples
            self.global_sum_metric = (stats.matthewscc(use_global=True)
                                      * stats.global_total_examples)
            self.global_num_inst = stats.global_total_examples

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0.0
        self.global_sum_metric = 0.0
        self.global_num_inst = 0.0
        self._metrics.reset()

    def reset_local(self):
        self.sum_metric = 0.0
        self.num_inst = 0.0
        self._metrics.reset_stats()


@register
class Perplexity(EvalMetric):
    """Perplexity (reference: metric.py:938)."""

    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, ignore_label=ignore_label,
                         output_names=output_names, label_names=label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label_np = _as_numpy(label).astype("int32")
            pred_np = _as_numpy(pred)
            assert label_np.size == pred_np.size / pred_np.shape[-1], \
                f"shape mismatch: {label_np.shape} vs. {pred_np.shape}"
            label_flat = label_np.reshape((label_np.size,))
            probs = pred_np.reshape(-1, pred_np.shape[-1])[
                numpy.arange(label_flat.size), label_flat]
            if self.ignore_label is not None:
                ignore = (label_flat == self.ignore_label).astype(probs.dtype)
                num -= int(ignore.sum())
                probs = probs * (1 - ignore) + ignore
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, probs)))
            num += label_flat.size
        self.sum_metric += loss
        self.global_sum_metric += loss
        self.num_inst += num
        self.global_num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name,
                math.exp(self.global_sum_metric / self.global_num_inst))


@register
class MAE(EvalMetric):
    """Mean absolute error (reference: metric.py:1025)."""

    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _as_numpy(label)
            pred_np = _as_numpy(pred)
            if len(label_np.shape) == 1:
                label_np = label_np.reshape(label_np.shape[0], 1)
            if len(pred_np.shape) == 1:
                pred_np = pred_np.reshape(pred_np.shape[0], 1)
            mae = numpy.abs(label_np - pred_np).mean()
            self.sum_metric += mae
            self.global_sum_metric += mae
            self.num_inst += 1
            self.global_num_inst += 1


@register
class MSE(EvalMetric):
    """Mean squared error (reference: metric.py:1083)."""

    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _as_numpy(label)
            pred_np = _as_numpy(pred)
            if len(label_np.shape) == 1:
                label_np = label_np.reshape(label_np.shape[0], 1)
            if len(pred_np.shape) == 1:
                pred_np = pred_np.reshape(pred_np.shape[0], 1)
            mse = ((label_np - pred_np) ** 2.0).mean()
            self.sum_metric += mse
            self.global_sum_metric += mse
            self.num_inst += 1
            self.global_num_inst += 1


@register
class RMSE(EvalMetric):
    """Root mean squared error (reference: metric.py:1141)."""

    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _as_numpy(label)
            pred_np = _as_numpy(pred)
            if len(label_np.shape) == 1:
                label_np = label_np.reshape(label_np.shape[0], 1)
            if len(pred_np.shape) == 1:
                pred_np = pred_np.reshape(pred_np.shape[0], 1)
            rmse = numpy.sqrt(((label_np - pred_np) ** 2.0).mean())
            self.sum_metric += rmse
            self.global_sum_metric += rmse
            self.num_inst += 1
            self.global_num_inst += 1


@register
class CrossEntropy(EvalMetric):
    """Cross entropy over class probabilities (reference:
    metric.py:1199)."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _as_numpy(label)
            pred_np = _as_numpy(pred)
            label_flat = label_np.ravel()
            assert label_flat.shape[0] == pred_np.shape[0]
            prob = pred_np[numpy.arange(label_flat.shape[0]),
                           numpy.int64(label_flat)]
            cross_entropy = (-numpy.log(prob + self.eps)).sum()
            self.sum_metric += cross_entropy
            self.global_sum_metric += cross_entropy
            self.num_inst += label_flat.shape[0]
            self.global_num_inst += label_flat.shape[0]


_METRIC_REGISTRY["ce"] = CrossEntropy


@register
class NegativeLogLikelihood(EvalMetric):
    """NLL (reference: metric.py:1265)."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _as_numpy(label)
            pred_np = _as_numpy(pred)
            label_flat = label_np.ravel()
            num_examples = pred_np.shape[0]
            assert label_flat.shape[0] == num_examples, \
                (label_flat.shape, pred_np.shape)
            prob = pred_np[numpy.arange(num_examples),
                           numpy.int64(label_flat)]
            nll = (-numpy.log(prob + self.eps)).sum()
            self.sum_metric += nll
            self.global_sum_metric += nll
            self.num_inst += num_examples
            self.global_num_inst += num_examples


_METRIC_REGISTRY["nll_loss"] = NegativeLogLikelihood


@register
class PearsonCorrelation(EvalMetric):
    """Pearson correlation (reference: metric.py:1330).

    ``average='micro'`` computes one coefficient over every example
    seen. Where the reference merges per-batch means/variances with a
    Welford-style update, here the five raw moments (sums of x, y, x^2,
    y^2, xy) are accumulated in float64 and the coefficient is formed
    once at ``get()`` — the streaming state is a single vector."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0
        # n, sum_l, sum_p, sum_ll, sum_pp, sum_lp
        self._moments = numpy.zeros(6, numpy.float64)
        self._anchor = None

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            check_label_shapes(label, pred, False, True)
            lab = _as_numpy(label).ravel().astype(numpy.float64)
            prd = _as_numpy(pred).ravel().astype(numpy.float64)
            if self.average == "macro":
                self._accum(numpy.corrcoef(prd, lab)[0, 1])
            else:
                self._accum(0.0)  # the value lives in the moments
                if self._anchor is None:
                    # Pearson is shift-invariant; centering every batch
                    # on the first batch's means keeps the accumulated
                    # squares O(variance) instead of O(mean^2), so
                    # large-mean data (timestamps, raw prices) does not
                    # cancel away the float64 mantissa
                    self._anchor = (lab.mean(), prd.mean())
                lab = lab - self._anchor[0]
                prd = prd - self._anchor[1]
                self._moments += (lab.size, lab.sum(), prd.sum(),
                                  lab @ lab, prd @ prd, lab @ prd)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        if self.average == "macro":
            return (self.name, self.sum_metric / self.num_inst)
        n, sl, sp, sll, spp, slp = self._moments
        cov = n * slp - sl * sp
        denom = numpy.sqrt((n * sll - sl * sl) * (n * spp - sp * sp))
        return (self.name, cov / denom if denom != 0 else float("nan"))


_METRIC_REGISTRY["pcc"] = PearsonCorrelation


@register
class Loss(EvalMetric):
    """Dummy metric averaging a pre-computed loss output (reference:
    metric.py:1477)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, _, preds):
        if isinstance(preds, list) and len(preds) > 0 \
                and not _is_array(preds[0]):
            preds = [preds]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        for pred in preds:
            loss = _as_numpy(pred).sum()
            self.sum_metric += loss
            self.global_sum_metric += loss
            n = 1
            for s in numpy.shape(_as_numpy(pred)):
                n *= s
            self.num_inst += n
            self.global_num_inst += n


@register
class CustomMetric(EvalMetric):
    """Wrap a ``feval(label, pred)`` function (reference: metric.py:1549)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = f"custom({name})"
        super().__init__(name, feval=feval,
                         allow_extra_outputs=allow_extra_outputs,
                         output_names=output_names, label_names=label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for pred, label in zip(preds, labels):
            # feval returns either a bare value (counted as one
            # instance) or a (sum, count) pair
            result = self._feval(_as_numpy(label), _as_numpy(pred))
            self._accum(*(result if isinstance(result, tuple)
                          else (result,)))

    def get_config(self):
        raise NotImplementedError("CustomMetric cannot be serialized")


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Create CustomMetric from a numpy feval (reference:
    metric.py:1625)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


@register
class VOCMApMetric(EvalMetric):
    """Pascal-VOC mean average precision for detection.

    Reference: example/ssd/evaluate/eval_metric.py (MApMetric /
    VOC07MApMetric). ``update(labels, preds)`` takes ground truth
    (N, G, >=5) rows [cls, x1, y1, x2, y2, (difficult)] padded with -1,
    and detections (N, A, 6) rows [cls, score, x1, y1, x2, y2] with
    suppressed rows cls=-1 (the MultiBoxDetection output convention).
    AP per class from the precision/recall curve; ``use_07_metric``
    selects the VOC-2007 11-point interpolation.
    """

    def __init__(self, iou_thresh=0.5, class_names=None,
                 use_07_metric=False, name="mAP", **kwargs):
        self.iou_thresh = iou_thresh
        self.class_names = class_names
        self.use_07_metric = use_07_metric
        super().__init__(name, **kwargs)

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0
        # per-class accumulators: scores, tp flags, gt counts
        self._records = {}
        self._gt_counts = {}

    def update(self, labels, preds):
        import numpy as onp

        for label, pred in zip(labels, preds):
            lab = _as_numpy(label)
            det = _as_numpy(pred)
            for b in range(lab.shape[0]):
                self._update_one(lab[b], det[b])

    @staticmethod
    def _iou_matrix(a, b):
        """(D, 4) x (G, 4) corner-box IoU via numpy broadcast."""
        import numpy as onp

        iw = (onp.minimum(a[:, None, 2], b[None, :, 2]) -
              onp.maximum(a[:, None, 0], b[None, :, 0])).clip(min=0)
        ih = (onp.minimum(a[:, None, 3], b[None, :, 3]) -
              onp.maximum(a[:, None, 1], b[None, :, 1])).clip(min=0)
        inter = iw * ih
        area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
        area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :]
        return inter / onp.maximum(area_a + area_b - inter, 1e-12)

    def _update_one(self, gts, dets):
        import numpy as onp

        gts = gts[gts[:, 0] >= 0]
        dets = dets[dets[:, 0] >= 0]
        # VOC protocol: 'difficult' ground truths (column 5 when present)
        # count neither toward recall nor as false positives
        difficult = (gts[:, 5] > 0 if gts.shape[1] > 5
                     else onp.zeros(len(gts), bool))
        order = onp.argsort(-dets[:, 1])
        dets = dets[order]
        for c in onp.unique(onp.concatenate([gts[:, 0], dets[:, 0]])):
            sel = gts[:, 0] == c
            gt_c = gts[sel][:, 1:5]
            diff_c = difficult[sel]
            det_c = dets[dets[:, 0] == c]
            self._gt_counts[c] = self._gt_counts.get(c, 0) + \
                int((~diff_c).sum())
            rec = self._records.setdefault(c, [])
            taken = onp.zeros(len(gt_c), bool)
            iou = (self._iou_matrix(det_c[:, 2:6], gt_c)
                   if len(gt_c) and len(det_c) else
                   onp.zeros((len(det_c), 0)))
            for di, d in enumerate(det_c):
                bi = int(onp.argmax(iou[di])) if iou.shape[1] else -1
                best = iou[di, bi] if bi >= 0 else 0.0
                if best >= self.iou_thresh and bi >= 0:
                    if diff_c[bi]:
                        continue        # matched a difficult gt: ignore
                    tp = not taken[bi]
                    taken[bi] = True
                else:
                    tp = False
                rec.append((float(d[1]), bool(tp)))

    def _average_precision(self, rec_list, n_gt):
        import numpy as onp

        if n_gt == 0:
            return None
        if not rec_list:
            return 0.0
        rec_list = sorted(rec_list, key=lambda t: -t[0])
        tp = onp.cumsum([t[1] for t in rec_list])
        fp = onp.cumsum([not t[1] for t in rec_list])
        recall = tp / n_gt
        precision = tp / onp.maximum(tp + fp, 1e-12)
        if self.use_07_metric:
            ap = 0.0
            for t in onp.arange(0.0, 1.1, 0.1):
                p = precision[recall >= t].max() if (recall >= t).any() \
                    else 0.0
                ap += p / 11.0
            return float(ap)
        # exact area under the interpolated PR curve
        mrec = onp.concatenate([[0.0], recall, [1.0]])
        mpre = onp.concatenate([[0.0], precision, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = onp.where(mrec[1:] != mrec[:-1])[0]
        return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())

    def get(self):
        aps = []
        for c, n_gt in self._gt_counts.items():
            ap = self._average_precision(self._records.get(c, []), n_gt)
            if ap is not None:
                aps.append(ap)
        value = float(sum(aps) / len(aps)) if aps else float("nan")
        return self.name, value


@register
class VOC07MApMetric(VOCMApMetric):
    """11-point interpolated VOC-2007 mAP (reference:
    example/ssd/evaluate/eval_metric.py VOC07MApMetric)."""

    def __init__(self, iou_thresh=0.5, class_names=None, name="mAP07",
                 **kwargs):
        super().__init__(iou_thresh=iou_thresh, class_names=class_names,
                         use_07_metric=True, name=name, **kwargs)

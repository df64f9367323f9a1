"""Gluon Estimator of the port: train/validate a net with an
event-handler loop (mirrors ``mxnet_tpu/gluon/contrib/estimator/
estimator.py``).

Reference: python/mxnet/gluon/contrib/estimator/estimator.py:42
(Estimator, fit:326, evaluate:272, fit_batch, evaluate_batch,
_prepare_default_handlers). One ``autograd.record()`` forward/backward
per batch on the device the data sits on, then ``Trainer.step`` (the
fused update kernel) from ``GradientUpdateHandler``; with
``fit(compiled_step=True)`` the whole step is one CUDA-graph replay a
batch (``Trainer.compile_step``). Batches may hold port ``NDArray``s,
tensors or numpy arrays (numpy goes to the default device: the card,
unless a ``with mx.cpu():`` block says otherwise).
"""
from __future__ import annotations

import numpy as np
import torch

from ...._device import resolve_device
from ....metric import Accuracy, Loss as LossMetric, EvalMetric
from .... import autograd
from ....ndarray.ndarray import NDArray
from ... import Trainer
from ...loss import Loss as GluonLoss
from .event_handler import (BatchBegin, BatchEnd, EpochBegin, EpochEnd,
                            TrainBegin, TrainEnd, MetricHandler,
                            StoppingHandler, LoggingHandler,
                            GradientUpdateHandler, StepTimerHandler)

__all__ = ["Estimator"]


def _as_tensor(x):
    """A batch leaf as a tensor: an NDArray's, a tensor as it is, numpy
    on the default device."""
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve_device(None))


class Estimator:
    """Facilitates training & validation (reference: estimator.py:42).

    Parameters
    ----------
    net : gluon Block (initialized)
    loss : gluon Loss
    train_metrics : EvalMetric or list (default: Accuracy)
    val_metrics : EvalMetric or list (defaults to copies of train)
    trainer : gluon Trainer (default: sgd lr=1e-3)
    """

    def __init__(self, net, loss, train_metrics=None, val_metrics=None,
                 trainer=None, context=None):
        self.net = net
        if not isinstance(loss, GluonLoss):
            raise ValueError("loss must be a gluon Loss")
        self.loss = loss
        self.train_metrics = self._to_list(train_metrics) or [Accuracy()]
        self.val_metrics = self._to_list(val_metrics) or \
            [type(m)() for m in self.train_metrics]
        self.train_loss_metric = LossMetric("train_loss")
        self.val_loss_metric = LossMetric("val_loss")
        self.trainer = trainer if trainer is not None else Trainer(
            net.collect_params(), "sgd", {"learning_rate": 1e-3})
        self.stop_training = False
        self._compiled_step = None
        self._compiled_step_auto = None
        self._step_applied = False

    @staticmethod
    def _to_list(m):
        if m is None:
            return None
        if isinstance(m, EvalMetric):
            return [m]
        return list(m)

    # ------------------------------------------------------------ batch --
    def fit_batch(self, batch):
        """One forward/backward; returns (data, label, pred, loss).
        Override for custom batch semantics (reference: fit_batch).

        With ``fit(compiled_step=...)`` the whole step — forward, loss,
        backward AND the optimizer update — runs as one compiled
        dispatch here; ``GradientUpdateHandler`` then skips its
        ``trainer.step`` for the batch (``_step_applied``)."""
        data, label = _as_tensor(batch[0]), _as_tensor(batch[1])
        if self._compiled_step is not None:
            out = self._compiled_step(data, label)
            if isinstance(out, tuple):
                # fit(compiled_step=True) convention: loss first, pred
                # rides along as the second program output
                loss, pred = out[0], out[1]
            else:
                # a user-built step whose loss_fn returns only the loss:
                # metric handlers skip pred=None, loss metrics still run
                loss, pred = out, None
            self._step_applied = True
            return data, label, pred, loss
        with autograd.record():
            pred = self.net(data)
            loss = self.loss(pred, label)
        autograd.backward(loss)
        return data, label, pred, loss

    def evaluate_batch(self, batch):
        data, label = _as_tensor(batch[0]), _as_tensor(batch[1])
        pred = self.net(data)
        loss = self.loss(pred, label)
        return data, label, pred, loss

    # ------------------------------------------------------------- eval --
    def evaluate(self, val_data, batch_axis=0):
        """Run validation, updating val metrics (reference:
        evaluate:272)."""
        for m in self.val_metrics:
            m.reset()
        self.val_loss_metric.reset()
        with autograd.pause(train_mode=False):
            for batch in val_data:
                _, label, pred, loss = self.evaluate_batch(batch)
                for m in self.val_metrics:
                    m.update(label, pred)
                self.val_loss_metric.update(0, loss)
        return {m.get()[0]: m.get()[1]
                for m in self.val_metrics + [self.val_loss_metric]}

    # -------------------------------------------------------------- fit --
    def fit(self, train_data, val_data=None, epochs=None,
            event_handlers=None, batches=None, device_prefetch=None,
            compiled_step=None):
        """Train for ``epochs`` epochs or ``batches`` batches
        (reference: fit:326).

        ``device_prefetch``: batches to stage onto device ahead of the
        step from a background thread (overlapping H2D with compute);
        defaults to ``MXNET_TPU_DATA_PREFETCH`` (0 = off). A source
        that already device-prefetches (e.g. a ``DataLoader`` with the
        same env default) keeps its own depth — the source wins, no
        second staging thread is stacked. The StepTimerHandler's
        ``mxtpu_training_data_fraction`` gauge shows the effect.

        ``compiled_step``: ``True`` runs the whole training step
        (forward + loss + backward + update) as one CUDA-graph replay
        per batch via ``trainer.compile_step`` (:class:`mxnet_tpu_torch.
        jit.CompiledTrainStep`, built once per estimator, returning
        ``(loss, pred)``); pass a pre-built ``CompiledTrainStep`` to
        share graphs across fits. Ineligible batches fall back to the
        eager path automatically."""
        if epochs is None and batches is None:
            epochs = 1
        if compiled_step is True:
            # built once per estimator: net/loss/trainer are fixed at
            # construction, so repeated fits reuse the same programs
            # instead of re-paying the whole-step capture
            if self._compiled_step_auto is None:
                net, loss_obj = self.net, self.loss

                def _loss_and_pred(x, y):
                    pred = net(x)
                    # pred rides along as a program output so the metric
                    # handlers see it without a second forward
                    return loss_obj(pred, y), pred
                self._compiled_step_auto = \
                    self.trainer.compile_step(_loss_and_pred)
            compiled_step = self._compiled_step_auto
        self._compiled_step = compiled_step or None
        handlers = self._prepare_handlers(val_data, epochs, batches,
                                          event_handlers)
        train_begin, epoch_begin, batch_begin, batch_end, epoch_end, \
            train_end = self._categorize(handlers)

        from ...data.prefetch import (DevicePrefetchIter,
                                      default_prefetch_depth)
        explicit = device_prefetch is not None
        if device_prefetch is None:
            device_prefetch = default_prefetch_depth()
        if device_prefetch and device_prefetch > 0:
            # sources with their own device-prefetch policy (DataLoader)
            # win over the ambient env default — including an explicit
            # opt-out (device_prefetch=0 at the loader) — and an already-
            # active stager is never double-wrapped
            active = isinstance(train_data, DevicePrefetchIter) or \
                getattr(train_data, "_device_prefetch", 0) > 0
            managed = isinstance(train_data, DevicePrefetchIter) or \
                hasattr(train_data, "_device_prefetch")
            if (explicit and not active) or (not explicit and not managed):
                train_data = DevicePrefetchIter(train_data,
                                                depth=device_prefetch)

        from ....observability.tracing import get_tracer
        tracer = get_tracer()
        self.stop_training = False
        for h in train_begin:
            h.train_begin(self)
        epoch = 0
        while not self.stop_training:
            # the epoch span parents everything the epoch causes — the
            # per-batch train_step spans AND the DevicePrefetchIter
            # staging spans on their worker thread (captured context).
            # NOT step-category: the per-batch spans inside it own the
            # device StepTraceAnnotation.
            with tracer.span("mxtpu.estimator.epoch", "epoch", None,
                             {"epoch": epoch}):
                for h in epoch_begin:
                    h.epoch_begin(self)
                for batch in train_data:
                    for h in batch_begin:
                        h.batch_begin(self, batch=batch)
                    data, label, pred, loss = self.fit_batch(batch)
                    for h in batch_end:
                        h.batch_end(self, batch=batch, pred=pred,
                                    label=label, loss=loss)
                    self._sync_stop(handlers)
                    if self.stop_training:
                        break
                for h in epoch_end:
                    h.epoch_end(self)
            epoch += 1
            self._sync_stop(handlers)
        for h in train_end:
            h.train_end(self)

    def _sync_stop(self, handlers):
        if any(getattr(h, "stop_training", False) for h in handlers):
            self.stop_training = True

    def _prepare_handlers(self, val_data, epochs, batches,
                          event_handlers):
        handlers = list(event_handlers or [])
        # defaults mirror _prepare_default_handlers: stopping, gradient
        # update, metrics; logging/validation only when asked for
        if not any(isinstance(h, StoppingHandler) for h in handlers):
            handlers.append(StoppingHandler(max_epoch=epochs,
                                            max_batch=batches))
        if not any(isinstance(h, GradientUpdateHandler)
                   for h in handlers):
            handlers.append(GradientUpdateHandler())
        if not any(isinstance(h, MetricHandler) for h in handlers):
            handlers.append(MetricHandler(
                self.train_metrics + [self.train_loss_metric]))
        if not any(isinstance(h, StepTimerHandler) for h in handlers):
            handlers.append(StepTimerHandler())
        from .event_handler import ValidationHandler
        if val_data is not None and \
                not any(isinstance(h, ValidationHandler)
                        for h in handlers):
            handlers.append(ValidationHandler(val_data, self.evaluate))
        key = lambda h: getattr(h, "priority", 0)  # noqa: E731
        return sorted(handlers, key=key)

    def _categorize(self, handlers):
        return ([h for h in handlers if isinstance(h, TrainBegin)],
                [h for h in handlers if isinstance(h, EpochBegin)],
                [h for h in handlers if isinstance(h, BatchBegin)],
                [h for h in handlers if isinstance(h, BatchEnd)],
                [h for h in handlers if isinstance(h, EpochEnd)],
                [h for h in handlers if isinstance(h, TrainEnd)])

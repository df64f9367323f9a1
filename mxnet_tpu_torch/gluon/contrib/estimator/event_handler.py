"""Estimator event handlers of the port (a copy of
``mxnet_tpu/gluon/contrib/estimator/event_handler.py``).

Reference: python/mxnet/gluon/contrib/estimator/event_handler.py
(EventHandler:37, StoppingHandler:82, MetricHandler:122,
ValidationHandler:160, LoggingHandler:226, CheckpointHandler:336,
EarlyStoppingHandler, GradientUpdateHandler). Same mixin protocol: a
handler subclasses one or more of the six phase bases and the Estimator
dispatches each phase to every handler that implements it, ordered by
``priority`` (lower runs first) where defined.

In the port, ``CheckpointOnPreemption`` takes the port's
``resilience.PreemptionGuard`` and ``Trainer.save_state``/``ckpt_wait``,
and ``StepTimerHandler`` drives the port's ``observability.StepTimer``.
Handlers log to ``mxnet_tpu_torch.estimator``.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as _np

__all__ = ["EventHandler", "TrainBegin", "TrainEnd", "EpochBegin",
           "EpochEnd", "BatchBegin", "BatchEnd", "StoppingHandler",
           "MetricHandler", "ValidationHandler", "LoggingHandler",
           "CheckpointHandler", "EarlyStoppingHandler",
           "GradientUpdateHandler", "CheckpointOnPreemption",
           "StepTimerHandler"]


class EventHandler:
    pass


class TrainBegin(EventHandler):
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd(EventHandler):
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin(EventHandler):
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd(EventHandler):
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin(EventHandler):
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd(EventHandler):
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop after max_epoch epochs or max_batch batches (reference:
    event_handler.py:82)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch is not None and \
                self.current_batch >= self.max_batch:
            self.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch is not None and \
                self.current_epoch >= self.max_epoch:
            self.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    """Reset train metrics each epoch, update them each batch
    (reference: event_handler.py:122)."""

    def __init__(self, metrics, priority=-1000):
        self.metrics = metrics or []
        self.priority = priority

    def epoch_begin(self, estimator, *args, **kwargs):
        for m in self.metrics:
            m.reset()

    def batch_end(self, estimator, *args, **kwargs):
        pred = kwargs.get("pred")
        label = kwargs.get("label")
        loss = kwargs.get("loss")
        from ....metric import Loss as _LossMetric
        for m in self.metrics:
            if isinstance(m, _LossMetric):
                if loss is not None:
                    m.update(0, loss)
            elif pred is not None and label is not None:
                m.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Run validation every ``epoch_period`` epochs / ``batch_period``
    batches (reference: event_handler.py:160)."""

    def __init__(self, val_data, eval_fn, epoch_period=1,
                 batch_period=None, priority=-1000):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.priority = priority
        self.current_batch = 0
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period is not None and \
                self.current_batch % self.batch_period == 0:
            self.eval_fn(self.val_data)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period is not None and \
                self.current_epoch % self.epoch_period == 0:
            self.eval_fn(self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd,
                     BatchBegin, BatchEnd):
    """Log training progress (reference: event_handler.py:226).
    ``log_interval`` is 'epoch' or a batch count."""

    def __init__(self, log_interval="epoch", metrics=None,
                 priority=_np.inf):
        self.log_interval = log_interval
        self.metrics = metrics or []
        self.priority = priority
        self.logger = logging.getLogger("mxnet_tpu_torch.estimator")
        self.batch_index = 0
        self.current_epoch = 0
        self.processed_samples = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        self.logger.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        t = time.time() - self.train_start
        self.logger.info("Training finished in %.3fs", t)

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.time()
        self.batch_index = 0
        self.processed_samples = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.batch_index += 1
        batch = kwargs.get("batch")
        if batch is not None:
            try:
                self.processed_samples += len(batch[0])
            except Exception:
                pass
        if isinstance(self.log_interval, int) and \
                self.batch_index % self.log_interval == 0:
            msg = ", ".join(f"{m.get()[0]}={m.get()[1]:.4f}"
                            for m in self.metrics)
            self.logger.info("[epoch %d batch %d] %s",
                             self.current_epoch, self.batch_index, msg)

    def epoch_end(self, estimator, *args, **kwargs):
        t = time.time() - self.epoch_start
        msg = ", ".join(f"{m.get()[0]}={m.get()[1]:.4f}"
                        for m in self.metrics)
        self.logger.info("[epoch %d] finished in %.3fs: %s",
                         self.current_epoch, t, msg)
        self.current_epoch += 1


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Save model+trainer state periodically; optionally only on metric
    improvement (reference: event_handler.py:336)."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 mode="auto", epoch_period=1, batch_period=None,
                 max_checkpoints=5, resume_from_checkpoint=False,
                 save_best=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.max_checkpoints = max_checkpoints
        self.save_best = save_best
        self.saved = []
        self.current_epoch = 0
        self.current_batch = 0
        if mode == "auto" and monitor is not None:
            name = monitor.get()[0]
            mode = "min" if "loss" in name or "error" in name else "max"
        self._cmp = (lambda a, b: a < b) if mode == "min" else \
            (lambda a, b: a > b)
        self.best = None

    def train_begin(self, estimator, *args, **kwargs):
        os.makedirs(self.model_dir, exist_ok=True)

    def _save(self, estimator, tag):
        path = os.path.join(self.model_dir,
                            f"{self.model_prefix}-{tag}.params")
        estimator.net.save_parameters(path)
        if estimator.trainer is not None and \
                hasattr(estimator.trainer, "save_states"):
            try:
                estimator.trainer.save_states(path + ".states")
            except Exception:
                pass
        self.saved.append(path)
        while len(self.saved) > self.max_checkpoints:
            old = self.saved.pop(0)
            for f in (old, old + ".states"):
                if os.path.exists(f):
                    os.remove(f)

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period is not None and \
                self.current_batch % self.batch_period == 0:
            self._save(estimator, f"batch{self.current_batch}")

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period is not None and \
                self.current_epoch % self.epoch_period == 0:
            if self.save_best and self.monitor is not None:
                val = self.monitor.get()[1]
                if self.best is None or self._cmp(val, self.best):
                    self.best = val
                    self._save(estimator, "best")
            else:
                self._save(estimator, f"epoch{self.current_epoch}")


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Stop when the monitored metric stops improving (reference:
    event_handler.py EarlyStoppingHandler)."""

    def __init__(self, monitor, min_delta=0, patience=0, mode="auto",
                 baseline=None):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.baseline = baseline
        name = monitor.get()[0]
        if mode == "auto":
            mode = "min" if "loss" in name or "error" in name else "max"
        self._mode = mode
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.wait = 0
        self.stopped_epoch = None
        self.current_epoch = 0
        self.best = self.baseline if self.baseline is not None else (
            _np.inf if self._mode == "min" else -_np.inf)

    def _improved(self, val):
        if self._mode == "min":
            return val < self.best - self.min_delta
        return val > self.best + self.min_delta

    def epoch_end(self, estimator, *args, **kwargs):
        val = self.monitor.get()[1]
        if self._improved(val):
            self.best = val
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stop_training = True
                self.stopped_epoch = self.current_epoch
        self.current_epoch += 1

    def train_end(self, estimator, *args, **kwargs):
        if self.stopped_epoch is not None:
            logging.getLogger("mxnet_tpu_torch.estimator").info(
                "Early stop at epoch %d: best %s=%.4f",
                self.stopped_epoch, self.monitor.get()[0], self.best)


class CheckpointOnPreemption(TrainBegin, BatchEnd, TrainEnd):
    """Preemption-aware checkpointing: a SIGTERM/SIGINT during training
    triggers ONE final full-state checkpoint at the next step boundary,
    then stops the training loop cleanly.

    The signal itself only sets a flag (resilience.PreemptionGuard);
    this handler polls it in ``batch_end`` — after the gradient update,
    when params/optimizer state are consistent — writes a
    resilience.checkpoint directory via ``trainer.save_state`` (plus the
    net's parameters for trainers without full-state support), and sets
    ``stop_training``. Resume with ``trainer.restore_state(ckpt_dir)``.

    priority: runs after GradientUpdateHandler (-2000) so the step that
    was in flight when the signal landed is fully applied before the
    save.
    """

    def __init__(self, ckpt_dir, signals=None, priority=-1000):
        from ....resilience import PreemptionGuard
        self.ckpt_dir = ckpt_dir
        self.priority = priority
        kwargs = {} if signals is None else {"signals": signals}
        self.guard = PreemptionGuard(**kwargs)
        self.stop_training = False
        self.current_batch = 0
        self.logger = logging.getLogger("mxnet_tpu_torch.estimator")

    def train_begin(self, estimator, *args, **kwargs):
        self.stop_training = False
        self.current_batch = 0
        self.guard.install()

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if not self.guard.requested or self.stop_training:
            return
        self.logger.warning(
            "Preemption signal %s received: checkpointing to %s and "
            "stopping", self.guard.signum, self.ckpt_dir)
        self._save(estimator)
        self.stop_training = True

    def train_end(self, estimator, *args, **kwargs):
        self.guard.uninstall()

    def _save(self, estimator):
        trainer = getattr(estimator, "trainer", None)
        if trainer is not None and hasattr(trainer, "save_state"):
            trainer.save_state(self.ckpt_dir)
            # this is the LAST checkpoint of a preempted run — with
            # MXNET_TPU_CKPT_ASYNC the save is in a background writer,
            # and exiting on the atexit flush would reduce a failed
            # write to a warning + exit 0. Join here so a failure
            # raises before the process reports a clean stop.
            if hasattr(trainer, "ckpt_wait"):
                trainer.ckpt_wait()
        else:
            # fall back to params-only via the atomic nd.save path
            os.makedirs(self.ckpt_dir, exist_ok=True)
            estimator.net.save_parameters(
                os.path.join(self.ckpt_dir, "preempt.params"))


class StepTimerHandler(TrainBegin, EpochBegin, BatchBegin, BatchEnd):
    """Step-time telemetry for the estimator loop, driving an
    ``observability.StepTimer``: the gap between one ``batch_end`` and
    the next ``batch_begin`` is input-pipeline wait, ``batch_begin`` to
    ``batch_end`` is compute (forward/backward/metrics + the trainer
    update, which GradientUpdateHandler at priority -2000 runs before
    this handler's batch_end at -100). Added by default in
    ``Estimator.fit`` — the step-time
    breakdown (``mxtpu_training_step_seconds``,
    ``data_wait_seconds``, ``compute_seconds``,
    ``examples_per_sec``) is the substrate every perf report reads.
    """

    def __init__(self, timer=None, priority=-100):
        self.priority = priority
        self._timer = timer

    @property
    def timer(self):
        if self._timer is None:
            from ....observability import StepTimer
            self._timer = StepTimer()
        return self._timer

    def train_begin(self, estimator, *args, **kwargs):
        self.timer  # create eagerly so fit always registers the series

    def epoch_begin(self, estimator, *args, **kwargs):
        # epoch-end work (validation passes, checkpoints) must not be
        # billed as input-pipeline wait of the next epoch's first step
        self.timer._last_end = None

    def batch_begin(self, estimator, *args, **kwargs):
        self.timer.begin_step()

    def batch_end(self, estimator, *args, **kwargs):
        batch = kwargs.get("batch")
        n = None
        if batch is not None:
            try:
                n = len(batch[0])
            except Exception:
                n = None
        self.timer.end_step(batch_size=n)


class GradientUpdateHandler(BatchEnd):
    """Perform the trainer step after each batch (reference:
    event_handler.py GradientUpdateHandler). Kept as a handler so users
    can reorder/replace the update (e.g. gradient accumulation)."""

    def __init__(self, priority=-2000):
        self.priority = priority

    def batch_end(self, estimator, *args, **kwargs):
        if getattr(estimator, "_step_applied", False):
            # fit_batch ran a CompiledTrainStep: the optimizer update
            # already happened inside the one-dispatch program
            estimator._step_applied = False
            return
        batch = kwargs.get("batch")
        n = len(batch[0]) if batch is not None else 1
        estimator.trainer.step(n)

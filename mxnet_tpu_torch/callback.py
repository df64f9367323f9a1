"""Training callbacks of the port (a copy of ``mxnet_tpu/callback.py``;
reference: python/mxnet/callback.py).

``do_checkpoint`` needs ``model.save_checkpoint``, which the port does not
have yet (ROADMAP.md §1 item 14): calling it raises
``NotImplementedError``."""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "module_checkpoint",
           "log_train_metric", "ProgressBar", "LogValidationMetricsCallback"]


def do_checkpoint(prefix, period=1):
    """Epoch callback saving prefix-epoch.params
    (reference: callback.py:38). Not ported: it writes through
    ``model.save_checkpoint`` (ROADMAP.md §1 item 14, ``model.py``)."""
    raise NotImplementedError(
        "callback.do_checkpoint needs model.save_checkpoint, which the "
        "port does not have yet (ROADMAP.md §1 item 14, model.py)")


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """reference: callback.py:64."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def log_train_metric(period, auto_reset=False):
    """reference: callback.py:90."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset_local()
    return _callback


class Speedometer:
    """samples/sec logger, same call contract as the reference
    (callback.py:117): a batch-end callback logging throughput (and the
    current metric values) every ``frequent`` batches.

    Implementation is a simple window timer: remember the monotonic clock
    at the start of each reporting window; when the window closes, report
    ``window_batches * batch_size / elapsed`` and start the next window.
    A batch counter going backwards (new epoch) resets the window.
    """

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._window_start = None   # (monotonic time, batch count)

    def __call__(self, param):
        count = param.nbatch
        if self._window_start is None or count < self._window_start[1]:
            self._window_start = (time.monotonic(), count)
            return
        t0, c0 = self._window_start
        if count % self.frequent != 0 or count == c0:
            return
        elapsed = time.monotonic() - t0
        speed = ((count - c0) * self.batch_size / elapsed
                 if elapsed > 0 else float("inf"))
        parts = [f"Epoch[{param.epoch}] Batch [{c0}-{count}]",
                 f"Speed: {speed:.2f} samples/sec"]
        if param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                parts.append(f"{name}={value:f}")
            if self.auto_reset:
                param.eval_metric.reset_local()
        logging.info("\t".join(parts))
        self._window_start = (time.monotonic(), count)


class ProgressBar:
    """ASCII progress bar (reference: callback.py:186)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    """reference: callback.py:211."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)

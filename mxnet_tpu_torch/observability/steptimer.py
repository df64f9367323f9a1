"""StepTimer: per-step wall time with a data-wait vs compute split.

The step-time breakdown is the first thing every training perf
investigation needs (TensorFlow's production experience and the MLPerf
TPU-pod reports both lead with it): a step is either waiting on the
input pipeline or computing, and the ratio tells you which side to
optimize. The timer splits wall time at the moment the batch becomes
available:

    data_wait = t(batch ready)  - t(previous step end)
    compute   = t(step end)     - t(batch ready)
    step      = data_wait + compute

Metrics (registered on the shared registry):

- ``mxtpu_training_steps_total``           counter
- ``mxtpu_training_step_seconds``          histogram (full step)
- ``mxtpu_training_data_wait_seconds``     histogram
- ``mxtpu_training_compute_seconds``       histogram
- ``mxtpu_training_examples_per_sec``      gauge (instantaneous)
- ``mxtpu_training_data_fraction``         gauge (wait / step)

Use either the context-manager form around the body of a training
loop::

    timer = StepTimer()
    for x, y in loader:          # wait measured up to step() entry
        with timer.step(batch_size=len(x)):
            loss = train_step(x, y)

or the explicit begin/end pair (what the estimator's
``StepTimerHandler`` drives from ``batch_begin``/``batch_end``).
"""
from __future__ import annotations

import time

from .registry import get_registry

__all__ = ["StepTimer"]


class StepTimer:
    """Step wall-time breakdown reporter. One instance per training
    loop; all instances share the registry series (``subsystem``
    prefixes the metric names, default ``training``)."""

    def __init__(self, registry=None, subsystem="training"):
        reg = registry if registry is not None else get_registry()
        p = f"mxtpu_{subsystem}"
        self._steps = reg.counter(
            f"{p}_steps_total", "Training steps timed.")
        self._step_h = reg.histogram(
            f"{p}_step_seconds", "Full step wall time (wait + compute).")
        self._wait_h = reg.histogram(
            f"{p}_data_wait_seconds",
            "Time blocked on the input pipeline before the step body.")
        self._compute_h = reg.histogram(
            f"{p}_compute_seconds",
            "Step body time (forward/backward/update).")
        self._rate_g = reg.gauge(
            f"{p}_examples_per_sec",
            "Instantaneous throughput of the last timed step.")
        self._frac_g = reg.gauge(
            f"{p}_data_fraction",
            "data_wait / step of the last timed step (input-bound when "
            "close to 1).")
        self._last_end = None
        self._t_begin = None
        self._pending_wait = 0.0

    # ------------------------------------------------------ explicit API --
    def begin_step(self):
        """The batch is available; compute starts now. Everything since
        the previous ``end_step`` counts as input-pipeline wait."""
        now = time.monotonic()
        self._pending_wait = (now - self._last_end
                              if self._last_end is not None else 0.0)
        self._t_begin = now

    def end_step(self, batch_size=None):
        """Step body finished; record the breakdown."""
        if self._t_begin is None:
            return
        now = time.monotonic()
        compute = now - self._t_begin
        wait = self._pending_wait
        step = wait + compute
        self._steps.inc()
        self._step_h.observe(step)
        self._wait_h.observe(wait)
        self._compute_h.observe(compute)
        if step > 0:
            self._frac_g.set(wait / step)
            if batch_size:
                self._rate_g.set(batch_size / step)
        self._last_end = now
        self._t_begin = None
        self._pending_wait = 0.0

    # ------------------------------------------------- context-manager --
    def step(self, batch_size=None):
        """``with timer.step(batch_size=n):`` around the step body."""
        return _StepScope(self, batch_size)

    @property
    def steps(self):
        return int(self._steps.value)


class _StepScope:
    def __init__(self, timer, batch_size):
        self._timer = timer
        self._batch_size = batch_size

    def __enter__(self):
        self._timer.begin_step()
        return self._timer

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self._timer.end_step(self._batch_size)
        else:
            # failed step: don't pollute the distribution, but unblock
            # the wait accounting for the next step
            self._timer._t_begin = None
            self._timer._last_end = time.monotonic()
        return False

"""Gluon Estimator of the port: high-level fit/evaluate with event
handlers (mirrors ``mxnet_tpu/gluon/contrib/estimator``).

Reference: python/mxnet/gluon/contrib/estimator/.
"""
from .estimator import Estimator  # noqa: F401
from .event_handler import (  # noqa: F401
    EventHandler, TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchBegin,
    BatchEnd, StoppingHandler, MetricHandler, ValidationHandler,
    LoggingHandler, CheckpointHandler, EarlyStoppingHandler,
    GradientUpdateHandler, CheckpointOnPreemption, StepTimerHandler)

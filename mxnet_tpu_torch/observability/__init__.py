"""mxnet_tpu_torch.observability — runtime observability of the port
(mirrors ``mxnet_tpu.observability``; standard library only).

- :mod:`.registry` — one process-wide :class:`MetricsRegistry`
  (counters, gauges, fixed-edge histograms) that the serving layer
  reports through under ``mxtpu_<subsystem>_<metric>``: ``serving``
  (``mxnet_tpu_torch.serving.telemetry``) and ``llm``
  (``mxnet_tpu_torch.serving.llm.metrics``); exported as Prometheus
  text (``get_registry().expose()``) and JSONL snapshots
  (``MXNET_TPU_METRICS_LOG``, ``MXNET_TPU_METRICS_INTERVAL``;
  ``tools/metrics_dump.py`` reads both).
- :mod:`.tracing` (:func:`get_tracer`) — nested host spans in a bounded
  ring, exported as Chrome-trace JSON, and ``record_function`` ranges
  on a running torch profiler's timeline.
- :mod:`.flightrecorder` (:func:`get_flightrecorder`) — the bounded
  black-box ring of request lifecycle events and control-plane
  decisions, atomic post-mortem bundles (``tools/flight_inspect.py``
  reads them) and the ``debug_status()`` surface of registered
  servers; :mod:`.exemplars` joins histogram buckets back to requests.
- :mod:`.steptimer` (:class:`StepTimer`) — a training step's wall time
  split into input wait and compute (``mxtpu_training_*``; the
  estimator's ``StepTimerHandler`` drives it); ``gluon.Trainer`` and the
  compiled step report the optimizer-step series beside it.
- :mod:`.compilemon` — the counterpart of the reference's ``jaxmon``:
  kernel builds and loads and CUDA-graph captures on
  ``mxtpu_xla_compile_*`` (:func:`compile_count`,
  :func:`install_jax_monitoring_bridge`).
- :mod:`.timeseries` (:class:`TimeSeriesRing`) — a bounded ring of
  registry snapshots with windowed ``rate()``/percentile queries;
  :mod:`.slo` (:class:`SLO`, :class:`SLOEngine`) evaluates latency /
  TTFT / availability objectives off it with multi-window burn rates
  (``mxtpu_slo_*``; a page/breach transition dumps a flight bundle);
  :mod:`.capacity` turns a window into the chips-per-M-users report.
- :mod:`.rollup` — per-kernel-family device time of an ``mx.profiler``
  capture.
"""
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       DEFAULT_TIME_BUCKETS, get_registry)
from .steptimer import StepTimer
from .compilemon import compile_count, install_jax_monitoring_bridge
from .tracing import Span, Tracer, get_tracer, validate_chrome_trace
from .timeseries import TimeSeriesRing
from .slo import (SLO, SLOEngine, STATUS_OK, STATUS_WARN, STATUS_PAGE,
                  STATUS_BREACH)
from .flightrecorder import (FlightRecorder, get_flightrecorder,
                             flight_ring_capacity, flight_triggers)
from .exemplars import EXEMPLARS_PER_BUCKET

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_TIME_BUCKETS", "get_registry", "StepTimer",
           "compile_count", "install_jax_monitoring_bridge",
           "Span", "Tracer", "get_tracer", "validate_chrome_trace",
           "TimeSeriesRing", "SLO", "SLOEngine", "STATUS_OK",
           "STATUS_WARN", "STATUS_PAGE", "STATUS_BREACH",
           "FlightRecorder", "get_flightrecorder",
           "flight_ring_capacity", "flight_triggers",
           "EXEMPLARS_PER_BUCKET"]

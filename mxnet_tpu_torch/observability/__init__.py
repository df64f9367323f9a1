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

Not ported yet (ROADMAP.md §1 item 14): ``steptimer``, ``timeseries``,
``slo``, ``capacity``, ``rollup``, and ``jaxmon`` (whose counterpart,
the compile count, is ``mxnet_tpu_torch.serving.telemetry``).
"""
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       DEFAULT_TIME_BUCKETS, get_registry)
from .tracing import Span, Tracer, get_tracer, validate_chrome_trace
from .flightrecorder import (FlightRecorder, get_flightrecorder,
                             flight_ring_capacity, flight_triggers)
from .exemplars import EXEMPLARS_PER_BUCKET

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_TIME_BUCKETS", "get_registry",
           "Span", "Tracer", "get_tracer", "validate_chrome_trace",
           "FlightRecorder", "get_flightrecorder",
           "flight_ring_capacity", "flight_triggers",
           "EXEMPLARS_PER_BUCKET"]

"""The compile counters of the port on the registry (the counterpart of
``mxnet_tpu/observability/jaxmon.py``, the ``jax.monitoring`` bridge).

The reference counts XLA backend compilations through ``jax.monitoring``
events. The port compiles two things, both at first use and both counted
here as they happen:

- a kernel library built by ``nvcc`` from ``csrc/`` (or from an ``rtc``
  source) and loaded, or a prebuilt ``.so`` found in ``_build/`` and
  loaded (``kernels._load``);
- a CUDA-graph capture, its warm run included (``kernels.capture``).

The series keep the reference's names, so expositions and dashboards keep
their lines:

- ``mxtpu_xla_compile_total``        counter — builds, loads and captures
- ``mxtpu_xla_compile_seconds``      histogram — seconds of each
- ``mxtpu_xla_cache_hits_total``     counter — prebuilt ``.so`` loads
- ``mxtpu_xla_events_total{event=}`` counter — registered and left at
  zero: the reference fills it from ``jax.monitoring``'s other events,
  and the port has no event stream of that kind.

Counting needs no install: ``kernels.py`` reports from the first build of
the process. ``kernels.build_count()`` and ``kernels.capture_count()``
stay the process's own tallies (the checks of "nothing built or captured
since" read them); this counter, which ``serving.telemetry.compile_count``
reads, is the registry's copy for expositions and starts again with the
registry (``MetricsRegistry.reset``, a fresh registry). Compare the two
by what moved between two readings, not by their totals.
:func:`install_jax_monitoring_bridge` keeps the reference's name; it
registers the series and returns the registry.
"""
from __future__ import annotations

from .registry import get_registry

__all__ = ["install_jax_monitoring_bridge", "compile_count", "note_compile"]

# builds run seconds to minutes, loads and captures milliseconds
_COMPILE_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                    10.0, 30.0, 60.0, 120.0, 300.0, 600.0)


def _metrics():
    reg = get_registry()
    return (
        reg.counter("mxtpu_xla_compile_total",
                    "Kernel library builds and loads (nvcc at first use, "
                    "or a prebuilt .so) and CUDA-graph captures."),
        reg.histogram("mxtpu_xla_compile_seconds",
                      "Duration of each kernel build or load and of each "
                      "CUDA-graph capture (its warm run included).",
                      buckets=_COMPILE_BUCKETS),
        reg.counter("mxtpu_xla_cache_hits_total",
                    "Kernel libraries loaded prebuilt from _build/ "
                    "without running nvcc."),
        reg.counter("mxtpu_xla_events_total",
                    "Other compile events by name (none in the port).",
                    ("event",)),
    )


def note_compile(seconds, cache_hit=False):
    """One build or load (``cache_hit``: a prebuilt library) or one
    capture, taking ``seconds``."""
    total, secs, hits, _ = _metrics()
    total.inc()
    secs.observe(seconds)
    if cache_hit:
        hits.inc()


def install_jax_monitoring_bridge():
    """Register the compile series (idempotent) and return the registry.
    Counting does not wait for this call."""
    _metrics()
    return get_registry()


def compile_count():
    """Builds, loads and captures in this process, from the counter."""
    return int(get_registry().counter("mxtpu_xla_compile_total").value)

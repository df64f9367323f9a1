"""mx.profiler of the port — the reference's surface
(``mxnet_tpu/profiler.py``) over ``torch.profiler``.

- ``set_state('run'/'stop')`` starts and stops a ``torch.profiler.profile``
  capture of the host (CPU activity) and, where a card is present, of the
  card (CUDA activity: kernels, copies, fills). The activities follow the
  device the run uses; the CPU alone is not a fallback for a card.
- At each stop the capture is written as a gzipped Chrome trace under the
  reference's layout, ``<filename>/plugins/profile/<run>/<host>.trace.json.gz``
  (``<run>`` a timestamp, one directory a capture section), so globs and
  :func:`mxnet_tpu_torch.observability.rollup.find_trace` read it the same.
- ``scope(name)`` is a ``torch.profiler.record_function`` range; while
  :func:`scopes_enabled` (a capture runs with ``profile_symbolic``) every
  gluon ``Block`` call is one too, named after the block.
- ``pause``/``resume``: a torch capture cannot pause either; ``pause()``
  closes the current section and ``resume()`` opens a new one in the same
  directory, as the reference's.
- ``dumps()`` aggregates the captured events into the reference's
  "aggregate stats" table (total/count/avg time per name, keyed on the
  name's first dot-separated part).

Lanes. The reference classifies a trace event by its process name
(``/device:TPU:0`` is device, ``/host:CPU`` host, anything else
unknown). A torch trace puts the card's work and the host's in lanes
named by pid and stream, so the port classifies by the event's category
(:data:`LANE_OF_CATEGORY`): ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` are ``device``; ``cpu_op``, ``user_annotation`` and
``python_function`` are ``host``; anything else (the CUDA runtime's
calls, ``gpu_user_annotation`` projections, ...) is ``unknown``.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import shutil
import socket
import tempfile
import time
from collections import Counter

__all__ = ["set_config", "set_state", "pause", "resume", "dump", "dumps",
           "scope", "host_scope", "state", "scopes_enabled",
           "profiler_set_config", "profiler_set_state"]

_config = {
    "filename": "profile_output",
    "profile_all": False,
    "profile_symbolic": True,   # Block-level named scopes
    "profile_imperative": True,
    "profile_memory": False,
    "profile_api": False,
    "aggregate_stats": True,
}
_state = "stop"
_scopes_enabled = False
_prof = None            # the running torch.profiler.profile
_runs = [0]             # capture sections written by this process

LANE_OF_CATEGORY = {
    "kernel": "device", "gpu_memcpy": "device", "gpu_memset": "device",
    "cpu_op": "host", "user_annotation": "host",
    "python_function": "host",
}


def set_config(**kwargs):
    """Configure the profiler (reference: profiler.py:40 set_config).
    ``filename`` names the output directory; ``profile_memory`` turns on
    torch's memory events; ``profile_symbolic`` the Block scopes."""
    unknown = set(kwargs) - set(_config)
    if unknown:
        raise ValueError(f"unknown profiler options: {sorted(unknown)}")
    _config.update(kwargs)


profiler_set_config = set_config


def _trace_dir():
    base = _config["filename"]
    if base.endswith(".json"):
        base = base[:-5]
    return base


def state():
    return _state


def _activities(torch):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def set_state(state_name="stop"):
    """'run' starts a capture, 'stop' ends it and writes its trace
    (reference: profiler.py:115 set_state)."""
    global _state, _scopes_enabled, _prof
    if state_name == "run":
        if _state != "run":
            import torch
            os.makedirs(_trace_dir(), exist_ok=True)
            _prof = torch.profiler.profile(
                activities=_activities(torch),
                profile_memory=bool(_config["profile_memory"]))
            _prof.start()
            _scopes_enabled = bool(_config["profile_symbolic"])
            _state = "run"
    elif state_name == "stop":
        if _state == "run":
            _scopes_enabled = False
            _state = "stop"
            prof, _prof = _prof, None
            prof.stop()
            _write_trace(prof)
    else:
        raise ValueError(f"invalid profiler state {state_name!r}")


profiler_set_state = set_state


def _write_trace(prof):
    """The capture as ``<dir>/plugins/profile/<run>/<host>.trace.json.gz``
    (``<run>`` a timestamp with this process's section count, so a
    pause/resume in the same second makes a new directory)."""
    _runs[0] += 1
    run = time.strftime("%Y_%m_%d_%H_%M_%S") + f"_{os.getpid()}_{_runs[0]}"
    out_dir = os.path.join(_trace_dir(), "plugins", "profile", run)
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".json", dir=out_dir)
    os.close(fd)
    try:
        prof.export_chrome_trace(tmp)
        path = os.path.join(out_dir, f"{socket.gethostname()}.trace.json.gz")
        with open(tmp, "rb") as src, gzip.open(path, "wb") as dst:
            shutil.copyfileobj(src, dst)
    finally:
        os.unlink(tmp)
    return path


def pause(profile_process="worker"):
    """Close the current capture section (reference: profiler.py:146)."""
    set_state("stop")


def resume(profile_process="worker"):
    """Open a new capture section in the same directory (reference:
    profiler.py:160)."""
    set_state("run")


def dump(finished=True, profile_process="worker"):
    """Flush the trace to disk (reference: profiler.py:173): the trace is
    written at stop, so this stops the capture."""
    if finished:
        set_state("stop")


def scopes_enabled():
    return _scopes_enabled


class scope:
    """Context manager adding a named range to the trace (a
    ``torch.profiler.record_function``; reference: profiler.Scope)."""

    def __init__(self, name="<unk>:"):
        self._name = name
        self._ctx = None

    def __enter__(self):
        import torch
        self._ctx = torch.profiler.record_function(self._name)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)


def host_scope(name):
    """Host-timeline span — one API, two sinks: a tracer span when the
    span tracer is enabled, a ``record_function`` range while a profiler
    capture runs (either way), and a shared no-op singleton when both are
    off (:meth:`mxnet_tpu_torch.observability.tracing.Tracer.span`)."""
    from .observability.tracing import get_tracer
    return get_tracer().span(name, "host")


def _load_trace_events():
    """Read every chrome-trace json the current trace dir holds."""
    pattern = os.path.join(_trace_dir(), "plugins", "profile", "**",
                           "*.trace.json.gz")
    events = []
    for path in sorted(glob.glob(pattern, recursive=True)):
        try:
            with gzip.open(path) as f:
                data = json.load(f)
        except Exception:
            continue
        events.extend(data.get("traceEvents", []))
    return events


def _lane_of(event):
    """'device', 'host' or 'unknown' from the event's category."""
    return LANE_OF_CATEGORY.get(event.get("cat", ""), "unknown")


def dumps(reset=False, format_="table", lane=None):
    """Aggregate stats from the captured trace (reference: profiler.py:194
    dumps): per-name total/count/avg time, sorted by total.

    Must be called after set_state('stop'). ``lane`` selects which
    events feed the table:

    - ``None`` (default) — device events, falling back to host+unknown
      when the capture has none (a CPU run);
    - ``'device'`` / ``'host'`` / ``'unknown'`` — exactly that class;
    - ``'both'`` (``format_='dict'`` only) — ``{lane: {"ops": {name:
      (total_us, count)}, "total_us": float, "count": int}}`` for all
      three classes.

    Returns a printable table, or with ``format_='dict'`` the raw
    ``{name: (total_us, count)}`` mapping.
    """
    events = _load_trace_events()

    def aggregate(lanes):
        tot, cnt = Counter(), Counter()
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            if _lane_of(e) not in lanes:
                continue
            key = e["name"].split(".")[0]
            tot[key] += e["dur"]
            cnt[key] += 1
        return tot, cnt

    if lane == "both":
        if format_ != "dict":
            raise ValueError("lane='both' requires format_='dict'")
        out = {}
        for cls in ("device", "host", "unknown"):
            tot, cnt = aggregate({cls})
            out[cls] = {"ops": {k: (tot[k], cnt[k]) for k in tot},
                        "total_us": float(sum(tot.values())),
                        "count": int(sum(cnt.values()))}
        return out
    if lane is not None:
        if lane not in ("device", "host", "unknown"):
            raise ValueError(f"invalid lane {lane!r}")
        tot, cnt = aggregate({lane})
    else:
        tot, cnt = aggregate({"device"})
        if not tot:
            tot, cnt = aggregate({"host", "unknown"})
    if format_ == "dict":
        return {k: (tot[k], cnt[k]) for k in tot}
    lines = [f"{'Name':<48} {'Total(us)':>12} {'Count':>8} {'Avg(us)':>10}"]
    lines.append("-" * 80)
    for name, total in tot.most_common():
        lines.append(f"{name[:48]:<48} {total:>12.1f} {cnt[name]:>8} "
                     f"{total / cnt[name]:>10.1f}")
    return "\n".join(lines)

"""mxnet_tpu_torch.resilience — the fault-tolerance primitives of the port
(mirrors ``mxnet_tpu.resilience``; standard library only).

- :mod:`.faults` — the deterministic fault-injection switchboard the
  chaos tests arm (scripted raises, gates, injected latency, crash
  points, writes killed at byte N, SIGTERM at step K); its hooks in the
  serving path are near-free no-ops until armed.
- :mod:`.atomic` — crash-safe file publication (temp + fsync + rename),
  which the flight recorder's bundles are written through.
- :mod:`.preemption` — :class:`PreemptionGuard`: SIGTERM/SIGINT → a flag
  polled by ``LLMServer.attach_preemption_guard``'s watcher thread.

The checkpoint modules (``checkpoint``, ``sharded``, ``retry``,
``async_writer``) are not ported yet (ROADMAP.md §1 items 6b and 14).
"""
from . import atomic, faults, preemption  # noqa: F401
from .atomic import atomic_write, is_temp_path
from .preemption import PreemptionGuard
from .faults import InjectedCrash

__all__ = ["atomic", "faults", "preemption", "atomic_write",
           "is_temp_path", "PreemptionGuard", "InjectedCrash"]

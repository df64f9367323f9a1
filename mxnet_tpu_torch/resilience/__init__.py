"""mxnet_tpu_torch.resilience — the fault-tolerance primitives of the port
(mirrors ``mxnet_tpu.resilience``; the on-disk formats are the
reference's, so either package reads the other's checkpoints).

- :mod:`.atomic` — crash-safe file publication (temp + fsync + rename);
  every durable write of the port (``nd.save``, checkpoints, the
  Trainer's states file, the flight recorder's bundles) uses it.
- :mod:`.checkpoint` — manifest-validated checkpoint directories with
  per-array CRC32, a ``LATEST`` pointer, and a newest-valid fallback
  scan.
- :mod:`.sharded` — the ``mxtpu-ckpt-v2`` layout: N parallel-written
  per-shard files + a layout manifest that makes restore elastic
  (assemble at any other world size from whichever shards hold the
  rows).
- :mod:`.async_writer` — background checkpoint saves: blocking host
  snapshot at the step boundary, serialize/fsync/prune off the critical
  path, at most one in flight, failed writes surfaced typed on the next
  save or wait.
- :mod:`.retry` — bounded exponential backoff with deterministic jitter.
- :mod:`.preemption` — :class:`PreemptionGuard`: SIGTERM/SIGINT → a flag
  polled at step boundaries (``LLMServer.attach_preemption_guard``'s
  watcher thread polls it too).
- :mod:`.faults` — the deterministic fault-injection switchboard the
  tests and chip_smoke arm (scripted raises, gates, injected latency,
  crash points, writes killed at byte N, SIGTERM at step K); its hooks
  are near-free no-ops until armed.
"""
from . import (atomic, faults, retry, preemption, sharded,  # noqa: F401
               checkpoint, async_writer)
from .atomic import atomic_write, is_temp_path
from .retry import RetryError, backoff_schedule, call_with_retry
from .retry import retry as with_retry
from .preemption import PreemptionGuard
from .checkpoint import (CheckpointManager, write_checkpoint,
                         latest_checkpoint, validate_checkpoint,
                         read_arrays, prune_checkpoints, snapshot_arrays)
from .async_writer import AsyncCheckpointWriter, AsyncSaveHandle
from .faults import InjectedCrash

__all__ = ["atomic", "faults", "retry", "preemption", "checkpoint",
           "sharded", "async_writer",
           "atomic_write", "is_temp_path", "RetryError",
           "backoff_schedule", "call_with_retry", "with_retry",
           "PreemptionGuard", "CheckpointManager", "write_checkpoint",
           "latest_checkpoint", "validate_checkpoint", "read_arrays",
           "prune_checkpoints", "snapshot_arrays",
           "AsyncCheckpointWriter", "AsyncSaveHandle", "InjectedCrash"]

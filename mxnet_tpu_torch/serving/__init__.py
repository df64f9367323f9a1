"""Serving layer of the PyTorch/CUDA port (mirrors ``mxnet_tpu.serving``).

- :class:`ModelServer` — dynamic micro-batching of concurrent
  single-sample requests (max batch + max queue delay) over a gluon
  Block, one CUDA graph per shape bucket on the card;
- :mod:`.bucketing` — pad micro-batches to a fixed set of bucket sizes
  (powers of two up to max batch); ``warmup()`` prepares every bucket,
  so steady-state serving builds and captures nothing;
- :mod:`.telemetry` — queue depth, wait time, padded-waste fraction,
  p50/p95/p99 latency, throughput and the compile count (kernel builds
  plus graph captures); the per-batch JSON-lines event log;
- :mod:`.llm` — the autoregressive counterpart: continuous-batching
  decoding over a paged KV cache (:class:`~.llm.LLMServer`);
- :mod:`.errors` — one typed exception hierarchy under
  :class:`ServingError`; :mod:`.overload` — the :class:`CircuitBreaker`;
- :mod:`.adapters` — multi-LoRA serving (:class:`~.adapters.AdapterBank`,
  :class:`~.adapters.AdapterRegistry`) and its fine-tune→publish loop
  (:class:`~.adapters.LoRAFineTuneJob`, trained through
  ``Trainer.compile_step``, and
  :class:`~.adapters.AdapterFineTunePublisher`);
- :mod:`.fleet` — N named models behind one router
  (:class:`~.fleet.FleetRouter`): atomic weight hot-swap from sharded
  checkpoints (publish→warm→drain→handover→prune), per-tenant
  token-bucket quotas + interactive/batch lanes, and the continuous
  fine-tune→publish loop (:class:`~.fleet.FineTunePublisher`).
"""
from .errors import (ServingError, ServerClosed, Overloaded,
                     CircuitOpenError, DeadlineExceededError,
                     SequenceEvictedError)
from .overload import CircuitBreaker
from .batching import MicroBatchQueue, Request
from .bucketing import (BucketSpec, bucket_sizes, pick_bucket,
                        pad_batch, pad_to_bucket, waste_fraction)
from .server import ModelServer
from .telemetry import (CompileCounter, EventLog, ServingStats,
                        compile_count)
from . import llm
from .llm import LLMServer, LLMEngine, GenerationResult
from . import adapters
from .adapters import (AdapterBank, AdapterRegistry, LoRAFineTuneJob,
                       AdapterFineTunePublisher)
from . import fleet
from .fleet import FleetRouter, FleetStats, FineTunePublisher

__all__ = ["ModelServer", "MicroBatchQueue", "Request",
           "ServingError", "ServerClosed", "Overloaded",
           "CircuitOpenError", "DeadlineExceededError",
           "SequenceEvictedError", "CircuitBreaker",
           "BucketSpec", "bucket_sizes", "pick_bucket", "pad_batch",
           "pad_to_bucket", "waste_fraction",
           "CompileCounter", "EventLog", "ServingStats", "compile_count",
           "llm", "LLMServer", "LLMEngine", "GenerationResult",
           "adapters", "AdapterBank", "AdapterRegistry",
           "LoRAFineTuneJob", "AdapterFineTunePublisher",
           "fleet", "FleetRouter", "FleetStats", "FineTunePublisher"]

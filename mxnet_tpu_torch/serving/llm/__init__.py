"""mxnet_tpu_torch.serving.llm — continuous-batching LLM decode serving
on PyTorch and CUDA (the port of ``mxnet_tpu.serving.llm``).

- :mod:`.kv_cache` — the paged KV pool (f32, int8 or fp8 pages), the
  strict refcounted :class:`~.kv_cache.BlockAllocator` and the
  content-hashed prefix cache with copy-on-write;
- :mod:`.model` — :class:`~.model.TinyDecoder`, whose flat ragged step
  ``decode_flat`` runs the port's hand-written CUDA kernels
  (:mod:`mxnet_tpu_torch.ops.ragged_attention`,
  :mod:`mxnet_tpu_torch.ops.quantization`);
- :mod:`.scheduler` / :mod:`.engine` — continuous batching with chunked
  prefill in one packed step, restart-based preemption;
- :mod:`.sampling` — temperature / top-k / top-p sampling on
  counter-based Philox noise keyed by (seed, position);
- :mod:`.quant` — per-output-channel int8/fp8 weight quantization;
- :mod:`.server` — :class:`~.server.LLMServer`: Futures in, generations
  out, typed drain/overload/deadline outcomes, quiesce/resume, the
  preemption drain and the statusz surface; :mod:`.metrics` keeps the
  ``mxtpu_llm_*`` registry series ``stats()`` reports.
"""
from ..errors import (DeadlineExceededError, Overloaded,
                      SequenceEvictedError)
from .kv_cache import (BlockAllocator, PagedKVCache, KVCacheError,
                       NoFreeBlocksError, BlockAccountingError,
                       NULL_BLOCK, prefix_block_hashes)
from .scheduler import Sequence, Scheduler
from .sampling import SamplingParams, GREEDY
from .model import DecoderConfig, TinyDecoder, greedy_decode_reference
from .quant import (QuantizedWeights, quantize_weights, fp8_supported,
                    resolve_weight_dtype)
from .engine import LLMEngine
from .metrics import LLMStats
from .server import LLMServer, GenerationResult

__all__ = [
    "BlockAllocator", "PagedKVCache", "KVCacheError",
    "NoFreeBlocksError", "BlockAccountingError", "NULL_BLOCK",
    "prefix_block_hashes",
    "Sequence", "Scheduler", "SamplingParams", "GREEDY",
    "DecoderConfig", "TinyDecoder",
    "greedy_decode_reference", "LLMEngine", "LLMStats", "LLMServer",
    "SequenceEvictedError", "DeadlineExceededError", "Overloaded",
    "GenerationResult",
    "QuantizedWeights", "quantize_weights", "fp8_supported",
    "resolve_weight_dtype",
]

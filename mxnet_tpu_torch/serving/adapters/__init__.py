"""Multi-LoRA serving on PyTorch and CUDA (the port of
``mxnet_tpu.serving.adapters``): many fine-tuned variants of one base
model served by one set of captured step graphs.

:class:`AdapterBank` (``bank.py``) keeps a fixed paged pool of LoRA A/B
factor pages on the device, accounted by the same strict refcounted
``BlockAllocator`` that backs the KV cache; an install copies into the
pools in place, so publishing, evicting or switching adapters captures
and builds nothing. Per-request adapters ride the step's batch as
tensors (``ops/lora.py``): see ``LLMServer.submit(adapter=...)``.

:class:`AdapterRegistry` (``registry.py``) is the on-disk tier below the
bank: sharded checkpoint manifests per adapter (the reference's layout),
more adapters than the bank has pages; the bank faults cold adapters in
from it, evicting cold residents.

:class:`LoRAFineTuneJob` / :class:`AdapterFineTunePublisher`
(``training.py``) are the fine-tune→publish loop: the base weights
frozen, only the A/B factors trained through ``Trainer.compile_step``
(one CUDA-graph replay a step on the card), each round published into
the bank (through its registry first, when it has one).
"""
# the engine imports the bank: load the LLM package first, so that an
# import of this package first finds it whole
from .. import llm as _llm  # noqa: F401
from .bank import (AdapterBank, AdapterHandle, AdapterError,
                   UnknownAdapterError, NoFreeAdapterPagesError,
                   AdapterAccountingError, NULL_ADAPTER_PAGE)
from .registry import AdapterRegistry
from .training import LoRAFineTuneJob, AdapterFineTunePublisher

__all__ = [
    "AdapterBank", "AdapterHandle", "AdapterRegistry",
    "AdapterError", "UnknownAdapterError", "NoFreeAdapterPagesError",
    "AdapterAccountingError", "NULL_ADAPTER_PAGE",
    "LoRAFineTuneJob", "AdapterFineTunePublisher",
]

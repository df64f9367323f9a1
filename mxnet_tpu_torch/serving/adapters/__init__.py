"""Multi-LoRA serving on PyTorch and CUDA (the port of
``mxnet_tpu.serving.adapters``): many fine-tuned variants of one base
model served by one set of captured step graphs.

:class:`AdapterBank` (``bank.py``) keeps a fixed paged pool of LoRA A/B
factor pages on the device, accounted by the same strict refcounted
``BlockAllocator`` that backs the KV cache; an install copies into the
pools in place, so publishing, evicting or switching adapters captures
and builds nothing. Per-request adapters ride the step's batch as
tensors (``ops/lora.py``): see ``LLMServer.submit(adapter=...)``.

The reference's ``AdapterRegistry`` and ``LoRAFineTuneJob`` /
``AdapterFineTunePublisher`` are not ported yet (ROADMAP.md, section 1
item 6b).
"""
# the engine imports the bank: load the LLM package first, so that an
# import of this package first finds it whole
from .. import llm as _llm  # noqa: F401
from .bank import (AdapterBank, AdapterHandle, AdapterError,
                   UnknownAdapterError, NoFreeAdapterPagesError,
                   AdapterAccountingError, NULL_ADAPTER_PAGE)

__all__ = [
    "AdapterBank", "AdapterHandle",
    "AdapterError", "UnknownAdapterError", "NoFreeAdapterPagesError",
    "AdapterAccountingError", "NULL_ADAPTER_PAGE",
]

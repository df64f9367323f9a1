"""Serving layer of the PyTorch/CUDA port (mirrors ``mxnet_tpu.serving``):
the paged LLM decode server in :mod:`.llm` and the shared pieces it
stands on (typed errors, overload protection, counters)."""
from .errors import (ServingError, ServerClosed, Overloaded,
                     CircuitOpenError, DeadlineExceededError,
                     SequenceEvictedError)

__all__ = ["ServingError", "ServerClosed", "Overloaded",
           "CircuitOpenError", "DeadlineExceededError",
           "SequenceEvictedError"]

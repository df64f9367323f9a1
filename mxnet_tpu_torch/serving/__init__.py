"""Serving layer of the PyTorch/CUDA port (mirrors ``mxnet_tpu.serving``):
the paged LLM decode server in :mod:`.llm` and the shared pieces it
stands on (typed errors, overload protection, the registry series and
the compile count)."""
from .errors import (ServingError, ServerClosed, Overloaded,
                     CircuitOpenError, DeadlineExceededError,
                     SequenceEvictedError)
from .telemetry import CompileCounter, compile_count

__all__ = ["ServingError", "ServerClosed", "Overloaded",
           "CircuitOpenError", "DeadlineExceededError",
           "SequenceEvictedError", "CompileCounter", "compile_count"]

"""Typed error hierarchy of the port (mirrors ``mxnet_tpu/error.py``).

The checkpoint stack raises :class:`CheckpointCorruptError` for a file
or directory that fails validation and :class:`CheckpointWriteError`
for a background save that failed; recovery paths catch them.
"""
from .base import MXNetError

__all__ = ["MXNetError", "InternalError", "ValueError", "TypeError",
           "IndexError", "CheckpointCorruptError", "CheckpointWriteError",
           "register_error"]


class InternalError(MXNetError):
    pass


class ValueError(MXNetError, ValueError):
    pass


class TypeError(MXNetError, TypeError):
    pass


class IndexError(MXNetError, IndexError):
    pass


class CheckpointCorruptError(InternalError):
    """A serialized NDArray container or checkpoint failed validation
    (bad magic, truncation, CRC mismatch). Recovery paths catch this to
    fall back to the newest valid checkpoint."""


class CheckpointWriteError(InternalError):
    """A background (async) checkpoint save failed. Raised on the next
    save, wait or close, never swallowed, with the original failure as
    ``__cause__``. The newest previously committed checkpoint is
    unaffected (partial directories never validate)."""


_ERROR_REGISTRY = {"MXNetError": MXNetError}
_ERROR_REGISTRY.update({
    c.__name__: c for c in (InternalError, ValueError, TypeError,
                            IndexError, CheckpointCorruptError)})


def register_error(func_name=None, cls=None):
    """Register a custom error class (reference: error.py register)."""
    def _do(c, name):
        _ERROR_REGISTRY[name] = c
        return c
    if callable(func_name) and cls is None:
        return _do(func_name, func_name.__name__)
    if cls is not None:
        return _do(cls, func_name or cls.__name__)
    return lambda c: _do(c, func_name or c.__name__)

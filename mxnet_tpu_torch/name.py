"""mx.name — NameManager / Prefix scopes for symbol naming (a copy of
``mxnet_tpu/name.py``).

Reference: python/mxnet/name.py (NameManager:25 auto-names symbols
op0, op1, ...; Prefix:74 prepends a fixed prefix). The Symbol layer
consults the active manager when no explicit ``name=`` is given.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]

_TLS = threading.local()


def _stack():
    if not hasattr(_TLS, "stack"):
        _TLS.stack = []
    return _TLS.stack


class NameManager:
    """Auto-naming scope (reference: name.py:25)."""

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name:
            return name
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return f"{hint}{idx}"

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False


class Prefix(NameManager):
    """Prefixing scope (reference: name.py:74):
    ``with mx.name.Prefix('stage1_'):``."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


def current():
    stack = _stack()
    if not stack:
        if not hasattr(_TLS, "default"):
            _TLS.default = NameManager()
        return _TLS.default
    return stack[-1]

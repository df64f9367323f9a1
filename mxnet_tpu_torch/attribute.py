"""mx.attribute — AttrScope for symbol attribute injection (a copy of
``mxnet_tpu/attribute.py``).

Reference: python/mxnet/attribute.py (AttrScope:26 — a thread-local
stack of attribute dicts applied to every Symbol created inside the
scope; used for ctx_group model-parallel hints, __lr_mult__, etc.).
Symbols here store the merged attributes in ``_attr``; the port places
nothing by ``ctx_group``, but the attributes round-trip through
save/load for tooling parity.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current", "get_current_attrs"]

_TLS = threading.local()


def _stack():
    if not hasattr(_TLS, "stack"):
        _TLS.stack = []
    return _TLS.stack


class AttrScope:
    """``with AttrScope(__lr_mult__='2.0'):`` attaches attributes to
    every Symbol created in the scope (reference: attribute.py:26)."""

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("attributes must be strings "
                                 "(reference AttrScope check)")
        self._attr = kwargs

    def get(self, attr=None):
        out = dict(self._attr)
        if attr:
            out.update(attr)
        return out

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False


def current():
    stack = _stack()
    return stack[-1] if stack else None


def get_current_attrs(extra=None):
    """Merged attributes of every active scope, innermost last."""
    out = {}
    for scope in _stack():
        out.update(scope._attr)
    if extra:
        out.update(extra)
    return out

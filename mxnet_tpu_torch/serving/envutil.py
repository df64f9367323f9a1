"""Shared env-var parsing for the serving config resolution order
(constructor arg > ``MXNET_TPU_*`` env var > default). One copy —
``LLMEngine`` and ``LLMServer`` resolve their knobs through these, so a
parsing fix can never drift between them.
An unset OR empty variable falls through to the default."""
from __future__ import annotations

import os

__all__ = ["env_int", "env_float", "env_str"]


def env_int(name, default):
    v = os.environ.get(name)
    return int(v) if v else default


def env_float(name, default):
    v = os.environ.get(name)
    return float(v) if v else default


def env_str(name, default):
    v = os.environ.get(name)
    return v if v else default

"""Autograd scopes of the port (mirrors ``mxnet_tpu/autograd.py``).

``record()``, ``pause()``, ``train_mode()`` and ``predict_mode()`` keep
MXNet's two thread-local flags: *recording* (``record()`` turns torch's
gradient mode on, ``pause()`` turns it off) and *training* (read by
layers such as ``Dropout``, which is active only under ``record()`` or
``train_mode()``). ``backward`` is torch's own ``Tensor.backward``; a
parameter's ``grad_req="write"`` (each backward replaces the gradient)
is kept by :mod:`mxnet_tpu_torch.gluon.parameter`.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training"]


class _AGState(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _AGState()


class _Scope:
    def __init__(self, recording, training):
        self._rec, self._train = recording, training
        self._grad = None

    def __enter__(self):
        self._old = (_STATE.recording, _STATE.training)
        if self._rec is not None:
            _STATE.recording = self._rec
            self._grad = torch.enable_grad() if self._rec else \
                torch.no_grad()
            self._grad.__enter__()
        if self._train is not None:
            _STATE.training = self._train
        return self

    def __exit__(self, *exc):
        if self._grad is not None:
            self._grad.__exit__(*exc)
            self._grad = None
        _STATE.recording, _STATE.training = self._old
        return False


def record(train_mode=True):
    """Scope whose operations are recorded for ``backward()``."""
    return _Scope(True, train_mode)


def pause(train_mode=False):
    """Scope whose operations are not recorded."""
    return _Scope(False, train_mode)


def train_mode():
    return _Scope(None, True)


def predict_mode():
    return _Scope(None, False)


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training

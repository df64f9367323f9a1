"""``nd``: the imperative array API of the port (a subset of
``mxnet_tpu/ndarray``): ``array``, ``zeros``, ``ones``, ``waitall`` and
the op namespace generated from the registry (every op of
:mod:`mxnet_tpu_torch.ops`, and those :mod:`mxnet_tpu_torch.rtc`
registers at run time).

Arrays are ``torch.Tensor``s (see :mod:`.register`). ``ctx`` is
``"cpu"``, ``"cuda"`` or a ``torch.device``; it defaults to the card and
raises without CUDA unless ``ctx="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import ops as _ops  # noqa: F401  (registers the ported ops)
from .._device import resolve_device
from . import register as _register

__all__ = ["array", "zeros", "ones", "waitall"]


def _device(ctx):
    return resolve_device("cuda" if ctx is None else ctx)


def _dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def array(source_array, ctx=None, dtype=None):
    """A tensor on ``ctx`` holding ``source_array``: numpy arrays and
    tensors keep their dtype (float64 becomes float32), anything else
    defaults to float32."""
    dev = _device(ctx)
    if isinstance(source_array, torch.Tensor):
        t = source_array
    else:
        if dtype is None and not isinstance(source_array, np.ndarray):
            dtype = np.float32
        t = torch.from_numpy(np.array(source_array))
    if dtype is None and t.dtype == torch.float64:
        dtype = np.float32
    return t.to(device=dev, dtype=_dtype(dtype))


def zeros(shape, ctx=None, dtype="float32"):
    return torch.zeros(shape, dtype=_dtype(dtype), device=_device(ctx))


def ones(shape, ctx=None, dtype="float32"):
    return torch.ones(shape, dtype=_dtype(dtype), device=_device(ctx))


def waitall():
    """Wait for all pending work on the card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


_register.populate(globals())

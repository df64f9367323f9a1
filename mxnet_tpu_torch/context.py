"""Device context of the port (mirrors ``mxnet_tpu/context.py``).

A :class:`Context` is the reference's hashable ``(device_type,
device_id)`` pair over a ``torch.device``: ``cpu()``, ``cpu_pinned()``
and ``cpu_shared`` name the host, ``gpu(i)`` names ``cuda:i``, and
``tpu(i)`` is kept as the reference keeps ``gpu``, an alias of the
accelerator, so reference code runs unchanged. ``with mx.cpu():`` sets
the device of array creation for the thread inside the block; outside
any block the default is the card (:func:`current_context` is
``gpu(0)``): the port's entry points run on the card unless asked for
the CPU, on a host without CUDA too, where resolving it raises.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["Context", "cpu", "gpu", "tpu", "cpu_pinned", "current_context",
           "num_gpus", "num_tpus", "device", "gpu_memory_info",
           "tpu_memory_info"]

_HOST_TYPES = ("cpu", "cpu_pinned", "cpu_shared")


class Context:
    """A device context: ``(device_type, device_id)``; a context manager
    that sets the default device of array creation on this thread."""

    # the reference's NDArray file codes (include/mxnet/base.h)
    devtype2mask = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 5,
                    "tpu": 6}
    devmask2type = {v: k for k, v in devtype2mask.items()}

    _tls = threading.local()

    __slots__ = ("device_type", "device_id")

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        if device_type not in self.devtype2mask:
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    @property
    def torch_device(self):
        """The ``torch.device`` this context names: the host for the cpu
        types, ``cuda:<device_id>`` for ``gpu`` and ``tpu``."""
        if self.device_type in _HOST_TYPES:
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        stack = getattr(Context._tls, "stack", None)
        if stack is None:
            stack = Context._tls.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._tls.stack.pop()
        return False

    def empty_cache(self):
        """Release the caching allocator's unused blocks on this card
        (nothing on the host)."""
        if self.device_type not in _HOST_TYPES and \
                torch.cuda.is_available():
            with torch.cuda.device(self.device_id):
                torch.cuda.empty_cache()

    def memory_info(self):
        """``(free, total)`` bytes of this card; ``(None, None)`` on the
        host."""
        if self.device_type in _HOST_TYPES or \
                not torch.cuda.is_available():
            return (None, None)
        return torch.cuda.mem_get_info(self.device_id)

    @classmethod
    def innermost(cls):
        """The context of the innermost ``with`` block on this thread, or
        None."""
        stack = getattr(cls._tls, "stack", None)
        return stack[-1] if stack else None

    @classmethod
    def default_ctx(cls):
        return cls.innermost() or Context("gpu", 0)


def cpu(device_id=0):
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    """The card ``device_id`` (``cuda:<device_id>``)."""
    return Context("gpu", device_id)


def tpu(device_id=0):
    """The accelerator ``device_id``, as ``gpu``: kept so reference code
    written against ``mx.tpu()`` runs unchanged."""
    return Context("tpu", device_id)


def device(dev):
    """A ``torch.device`` (or its string) as a Context."""
    dev = torch.device(dev)
    if dev.type == "cpu":
        return Context("cpu", 0)
    if dev.type != "cuda":
        raise ValueError(f"no context for device type {dev.type!r}")
    index = dev.index
    if index is None:
        index = torch.cuda.current_device() if torch.cuda.is_available() \
            else 0
    return Context("gpu", index)


def num_gpus():
    """The number of CUDA devices."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


num_tpus = num_gpus


def current_context():
    """The innermost ``with`` block's context on this thread, else the
    card, ``gpu(0)``."""
    return Context.default_ctx()


def gpu_memory_info(device_id=0):
    """``(free, total)`` bytes of card ``device_id``."""
    return gpu(device_id).memory_info()


tpu_memory_info = gpu_memory_info

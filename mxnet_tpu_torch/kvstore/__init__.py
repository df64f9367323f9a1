"""KVStore of the port (mirrors ``mxnet_tpu/kvstore``): the
single-process store (``mx.kv.create("local")`` / ``"device"``, class
:class:`KVStore`) with its updater, optimizer states, row-sparse pulls
and pushes, and 2-bit gradient compression (:mod:`.compression`).

The collective store of the reference (``dist_sync``, ``dist_async``,
``tpu``, ``horovod``, ``p3``: ``mxnet_tpu/kvstore/tpu.py``) waits for
the port's ``torch.distributed`` work: :func:`create` raises
``NotImplementedError`` naming ROADMAP.md §1 item 9.
"""
from .base import KVStoreBase, KVStoreLocal, create  # noqa: F401
from .kvstore import KVStore  # noqa: F401

__all__ = ["KVStoreBase", "KVStoreLocal", "KVStore", "create"]

"""The default single-process store, type ``"device"`` (mirrors
``mxnet_tpu/kvstore/kvstore.py``)."""
from __future__ import annotations

from .base import KVStoreLocal

__all__ = ["KVStore"]


class KVStore(KVStoreLocal):
    """The single-process store of ``create("local")`` and
    ``create("device")``."""

    @property
    def type(self):
        return "device"

    def send_command_to_servers(self, head, body):
        """One process: there are no servers to command."""

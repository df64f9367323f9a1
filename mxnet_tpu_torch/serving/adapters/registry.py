"""AdapterRegistry: the on-disk tier below the resident AdapterBank (the
port of ``mxnet_tpu/serving/adapters/registry.py``: the same directory
layout, so either package reads the other's registry).

One directory per adapter name, each holding sharded-manifest
checkpoints (``resilience/checkpoint.py``) of the LoRA factors —
version = checkpoint step, CRC-validated on read, ``keep`` pruning per
adapter. The registry can hold far more adapters than the bank has
pages: the bank faults cold entries in on demand
(:meth:`AdapterBank.acquire`) and capacity-evicts residents knowing
the registry can always restore them. Factors are host float32 numpy
arrays on both sides of the disk.
"""
from __future__ import annotations

import os
import re

import numpy as np

from ...resilience.checkpoint import (write_checkpoint,
                                      latest_checkpoint, read_arrays)

__all__ = ["AdapterRegistry"]

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


class AdapterRegistry:
    """Durable adapter store under ``root``; ``num_shards`` shards the
    factor checkpoints, ``keep`` bounds retained versions per adapter.
    Safe for concurrent readers; one writer per adapter name at a time
    (the checkpoint commit itself is atomic)."""

    def __init__(self, root, num_shards=None, keep=3):
        self.root = str(root)
        self.num_shards = num_shards
        self.keep = keep
        os.makedirs(self.root, exist_ok=True)

    def _dir(self, name):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad adapter name {name!r} (want "
                             "[A-Za-z0-9._-], no leading separator)")
        return os.path.join(self.root, name)

    def save(self, name, a, b, alpha=None, version=1):
        """Commit one adapter version; returns the checkpoint path."""
        arrays = {"lora_a": np.asarray(a, np.float32),
                  "lora_b": np.asarray(b, np.float32)}
        extra = {"adapter": name, "version": int(version),
                 "rank": int(arrays["lora_a"].shape[-1]),
                 "alpha": None if alpha is None else float(alpha)}
        return write_checkpoint(self._dir(name), arrays,
                                step=int(version), extra=extra,
                                keep=self.keep,
                                num_shards=self.num_shards)

    def load(self, name):
        """Newest valid version of ``name`` as
        ``(a, b, alpha, version)``; raises ``KeyError`` when absent."""
        path, manifest = latest_checkpoint(self._dir(name))
        if path is None:
            raise KeyError(f"adapter {name!r} not in registry "
                           f"{self.root}")
        arrays = read_arrays(path, manifest=manifest)
        extra = manifest.get("extra") or {}
        return (arrays["lora_a"].float().numpy(),
                arrays["lora_b"].float().numpy(),
                extra.get("alpha"),
                int(extra.get("version", manifest.get("step", 1))))

    def has(self, name):
        try:
            d = self._dir(name)
        except ValueError:
            return False
        if not os.path.isdir(d):
            return False
        path, _ = latest_checkpoint(d)
        return path is not None

    def names(self):
        """Adapter names with at least one committed version."""
        try:
            entries = sorted(os.listdir(self.root))
        except OSError:
            return []
        return [n for n in entries if self.has(n)]

"""KVStore base, the single-process store and ``create`` (mirrors
``mxnet_tpu/kvstore/base.py``).

:class:`KVStoreLocal` keeps one value a key on the device it was given
on: a tensor, or a ``nd.sparse.RowSparseNDArray`` after a row-sparse
push. It takes tensors and NDArrays alike (a gluon parameter's
``list_grad()`` is a list of tensors). ``push`` sums a list of values
(row-sparse values stay row-sparse: their ids and rows concatenate),
passes the sum to the updater when one is set (``set_updater``,
``set_optimizer``), else stores it; ``pull`` copies the value into each
``out`` in place; ``row_sparse_pull`` gathers only the rows asked for.
With ``set_gradient_compression`` each dense pushed value goes through
2-bit compression with its own residual (key, slot in the list) before
the sum, as each worker's push does in the reference.

The collective stores (``dist_*``, ``tpu``, ``horovod``, ``p3``) are
not ported yet: :func:`create` raises ``NotImplementedError`` naming
ROADMAP.md §1 item 9.

Metrics on the process registry, labelled by store type:
``mxtpu_kvstore_allreduce_total`` (key groups pushed),
``mxtpu_kvstore_allreduce_bytes_total`` (bytes entering the sum) and
``mxtpu_kvstore_allreduce_seconds`` (host time of a push).
"""
from __future__ import annotations

import time

import torch

from ..ndarray.ndarray import unwrap
from ..ndarray.sparse import RowSparseNDArray, add as _sparse_add

__all__ = ["KVStoreBase", "KVStoreLocal", "create"]

_DIST_TYPES = ("tpu", "dist", "dist_sync", "dist_device_sync", "dist_async",
               "horovod", "p3")


def _collective_obs():
    """The store's metrics (a push's latency takes the registry's default
    edges without the 60 s one)."""
    from ..observability import get_registry
    from ..observability.registry import DEFAULT_TIME_BUCKETS
    reg = get_registry()
    return {
        "count": reg.counter(
            "mxtpu_kvstore_allreduce_total",
            "Gradient reduce operations (one per key group pushed).",
            ("store",)),
        "bytes": reg.counter(
            "mxtpu_kvstore_allreduce_bytes_total",
            "Payload bytes entering the reduce (one contribution per "
            "replica).", ("store",)),
        "secs": reg.histogram(
            "mxtpu_kvstore_allreduce_seconds",
            "Host wall time of one push (local reduce + collective "
            "dispatch).", ("store",), buckets=DEFAULT_TIME_BUCKETS[:-1]),
    }


def _nbytes(v):
    t = v._values if isinstance(v, RowSparseNDArray) else v
    return t.numel() * t.element_size()


def _value(v):
    """A pushed or initial value as the store keeps it: a
    RowSparseNDArray as it is, anything else as a tensor."""
    if isinstance(v, RowSparseNDArray):
        return v
    v = unwrap(v)
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v)


def _dense(v):
    return v._data if isinstance(v, RowSparseNDArray) else v


class KVStoreBase:
    """The store interface and its registry of backends."""

    kv_registry = {}

    OPTIMIZER = "optimizer"

    @staticmethod
    def register(klass):
        """Register a backend under its lowercased class name."""
        KVStoreBase.kv_registry[klass.__name__.lower()] = klass
        return klass

    def broadcast(self, key, value, out, priority=0):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        raise NotImplementedError

    @staticmethod
    def is_capable(capability):
        raise NotImplementedError

    @property
    def type(self):
        raise NotImplementedError

    @property
    def rank(self):
        raise NotImplementedError

    @property
    def num_workers(self):
        raise NotImplementedError

    def save_optimizer_states(self, fname, dump_optimizer=False):
        raise NotImplementedError

    def load_optimizer_states(self, fname):
        raise NotImplementedError


class KVStoreLocal(KVStoreBase):
    """Single-process store: a push sums its values on their device."""

    def __init__(self):
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._compressor = None
        self._residuals = {}
        self._obs_cache = None

    def _obs_children(self):
        if self._obs_cache is None:
            obs = _collective_obs()
            self._obs_cache = {k: obs[k].labels(store=self.type)
                               for k in ("count", "bytes", "secs")}
        return self._obs_cache

    def init(self, key, value):
        """Store a copy of each value under its key (a key already
        stored keeps its value)."""
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            if k not in self._store:
                self._store[k] = _dense(_value(v)).detach().clone()

    def push(self, key, value, priority=0):
        """Sum each key's values, then update the stored value through
        the updater, or replace it."""
        keys, values = _key_value(key, value)
        obs = self._obs_children()
        t0 = time.monotonic()
        groups = 0
        for k, vlist in _group(keys, [_value(v) for v in values]):
            groups += 1
            obs["bytes"].inc(sum(_nbytes(v) for v in vlist))
            sparse = [isinstance(v, RowSparseNDArray) for v in vlist]
            if self._compressor is not None and not any(sparse):
                vlist = [self._compressed(k, i, v)
                         for i, v in enumerate(vlist)]
            reduced = vlist[0]
            if len(vlist) > 1:
                if all(sparse):
                    for v in vlist[1:]:
                        reduced = _sparse_add(reduced, v)
                else:
                    reduced = _dense(reduced).clone()
                    for v in vlist[1:]:
                        reduced += _dense(v).to(reduced.device)
            if self._updater is not None:
                self._updater(_str2int(k), reduced, self._store[k])
            elif isinstance(reduced, RowSparseNDArray):
                self._store[k] = RowSparseNDArray(
                    reduced._values, reduced._indices, reduced._sshape)
            else:
                self._store[k] = reduced.detach().clone()
        obs["count"].inc(groups)
        obs["secs"].observe(time.monotonic() - t0)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's value into its ``out`` arrays, in place."""
        keys, outs = _key_value(key, out)
        for k, olist in _group(keys, outs):
            src = self._store[k]
            for o in olist:
                _copy_into(src, o)

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` names (each once, sorted): a
        RowSparseNDArray ``out`` gets them as its ids and rows, a dense
        ``out`` those rows and zeros elsewhere. The whole value is never
        copied."""
        if row_ids is None:
            return self.pull(key, out, priority)
        keys, outs = _key_value(key, out)
        rids = row_ids if isinstance(row_ids, (list, tuple)) else \
            [row_ids] * len(keys)
        for (k, olist), rid in zip(_group(keys, outs), rids):
            src = _dense(self._store[k])
            rows = torch.unique(torch.as_tensor(unwrap(rid)).to(
                src.device).long().reshape(-1))
            vals = src[rows]
            for o in olist:
                if isinstance(o, RowSparseNDArray):
                    o._indices, o._values = rows, vals
                    o._sshape = tuple(src.shape)
                    o._dense = None
                else:
                    t = unwrap(o)
                    with torch.no_grad():
                        t.zero_()
                        t[rows] = vals.to(t.dtype)

    @property
    def fused_reduce_compatible(self):
        """True while the push is a plain sum (no updater, no
        compression)."""
        return self._updater is None and self._compressor is None

    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        from ..optimizer import get_updater
        self._optimizer = optimizer
        self.set_updater(get_updater(optimizer))

    def set_gradient_compression(self, compression_params):
        """2-bit compression with error feedback on the push path."""
        from . import compression as _gc
        self._compressor = _gc.create(compression_params)
        self._residuals = {}

    @property
    def gradient_compression(self):
        return self._compressor

    def _compressed(self, key, slot, value):
        """One value through its residual's compression: what the
        receiving side would see."""
        res = self._residuals.get((key, slot))
        if res is None or res.shape != value.shape:
            res = torch.zeros_like(value)
        deq, res = self._compressor.roundtrip(value, res)
        self._residuals[(key, slot)] = res
        return deq

    @staticmethod
    def is_capable(capability):
        return capability == KVStoreBase.OPTIMIZER

    @property
    def type(self):
        return "local"

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def barrier(self):
        pass

    def save_optimizer_states(self, fname, dump_optimizer=False):
        assert self._updater is not None, "updater is not set"
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        assert self._updater is not None, "updater is not set"
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())


def _copy_into(src, o):
    """Copy a stored value into ``out`` ``o`` in place (a
    RowSparseNDArray ``o`` takes a row-sparse value's parts)."""
    if isinstance(o, RowSparseNDArray):
        if isinstance(src, RowSparseNDArray):
            o._indices, o._values = src._indices, src._values
            o._sshape, o._dense = src._sshape, None
            return
        o._dense = None
        o._values = src.clone()
        o._indices = torch.arange(src.shape[0], device=src.device)
        o._sshape = tuple(src.shape)
        return
    t = unwrap(o)
    with torch.no_grad():
        t.copy_(_dense(src))


def _str2int(k):
    try:
        return int(k)
    except ValueError:
        return k


def _key_value(key, value):
    if isinstance(key, (list, tuple)):
        keys, values = [], []
        for k, v in zip(key, value):
            if isinstance(v, (list, tuple)):
                keys.extend([k] * len(v))
                values.extend(v)
            else:
                keys.append(k)
                values.append(v)
        return keys, values
    if isinstance(value, (list, tuple)):
        return [key] * len(value), list(value)
    return [key], [value]


def _group(keys, values):
    seen, order = {}, []
    for k, v in zip(keys, values):
        if k not in seen:
            seen[k] = []
            order.append(k)
        seen[k].append(v)
    return [(k, seen[k]) for k in order]


def create(name="local"):
    """A store by type name: ``local``, ``device``,
    ``local_allreduce_cpu``, ``local_allreduce_device`` and ``nccl`` give
    the single-process :class:`~.kvstore.KVStore`; a registered backend's
    name gives it; the collective types raise ``NotImplementedError``."""
    name = name.lower()
    if name in ("local", "device", "local_allreduce_cpu",
                "local_allreduce_device", "nccl"):
        from .kvstore import KVStore
        return KVStore()
    if name in _DIST_TYPES:
        raise NotImplementedError(
            f"KVStore type {name!r}: the collective store over "
            "torch.distributed is not ported yet (ROADMAP.md §1 item 9)")
    if name in KVStoreBase.kv_registry:
        return KVStoreBase.kv_registry[name]()
    raise ValueError(f"unknown KVStore type {name!r}")

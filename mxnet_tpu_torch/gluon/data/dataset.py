"""Datasets of the port (mirrors ``mxnet_tpu/gluon/data/dataset.py``).
Samples stay on the host: a dataset's arrays are numpy arrays or CPU
NDArrays, and the ``DataLoader`` (or the caller) moves batches to the
card."""
from __future__ import annotations

import os

from ...ndarray.ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Abstract dataset: ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        """The samples for which ``fn(sample)`` is true."""
        return SimpleDataset([i for i in self if fn(i)])

    def shard(self, num_shards, index):
        """Shard ``index`` of ``num_shards`` contiguous shards (the first
        ``len % num_shards`` one sample longer)."""
        if not 0 <= index < num_shards:
            raise ValueError(f"shard index {index} out of range "
                             f"[0, {num_shards})")
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return SimpleDataset([self[i] for i in range(start, end)])

    def take(self, count):
        """The first ``count`` samples (all for None)."""
        if count is None or count > len(self):
            count = len(self)
        return SimpleDataset([self[i] for i in range(count)])

    def transform(self, fn, lazy=True):
        """``fn`` applied to each sample (a tuple sample unpacked into
        its arguments): at each read when ``lazy``, else now."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """``fn`` applied to the first element of each sample."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    """A list (or anything indexable) as a dataset."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """Arrays (or lists) of one length zipped: sample ``i`` is the tuple
    of their ``i``-th elements (the element alone for one array)."""

    def __init__(self, *args):
        if not args:
            raise ValueError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            if len(data) != self._length:
                raise ValueError(
                    f"All arrays must have the same length; data[0] has "
                    f"length {self._length} while data[{i}] has "
                    f"{len(data)}.")
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """A dataset over a RecordIO ``.rec``/``.idx`` pair: item ``i`` is
    the bytes of the record of the ``i``-th key (reference: dataset.py:211
    + recordio.py)."""

    def __init__(self, filename):
        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        from ...recordio import MXIndexedRecordIO
        self._record = MXIndexedRecordIO(self.idx_file, self.filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)

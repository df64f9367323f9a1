"""Samplers of the port (mirrors ``mxnet_tpu/gluon/data/sampler.py``).
``RandomSampler`` shuffles with numpy's global generator, as the
reference does, so one seed gives the same order in both packages."""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "FilterSampler", "IntervalSampler"]


class Sampler:
    """An iterable of sample indices."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    """``start, start + 1, ..., start + length - 1``."""

    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """A permutation of ``range(length)``, drawn anew each pass."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        indices = np.arange(self._length)
        np.random.shuffle(indices)
        return iter(indices.tolist())

    def __len__(self):
        return self._length


class FilterSampler(Sampler):
    """The indices of the samples for which ``fn(sample)`` is true."""

    def __init__(self, fn, dataset):
        self._indices = [i for i, sample in enumerate(dataset)
                         if fn(sample)]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class IntervalSampler(Sampler):
    """Every ``interval``-th index from 0, then (``rollover``) from 1,
    2, ..., ``interval - 1``."""

    def __init__(self, length, interval, rollover=True):
        if interval > length:
            raise ValueError(f"interval {interval} exceeds length {length}")
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            yield from range(i, self._length, self._interval)

    def __len__(self):
        return self._length


_LAST_BATCH = ("keep", "discard", "rollover")


class BatchSampler(Sampler):
    """A sampler's indices in batches of ``batch_size``; the last short
    batch is kept, discarded or rolled over into the next pass."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in _LAST_BATCH:
            raise ValueError(
                "last_batch must be one of 'keep', 'discard', or "
                f"'rollover', but got {last_batch}")
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) // \
                self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        return (len(self._prev) + len(self._sampler)) // self._batch_size

"""DataLoader of the port (mirrors
``mxnet_tpu/gluon/data/dataloader.py``).

Samples are read and batched on the host. With ``num_workers > 0`` the
reads run in worker processes started by ``forkserver`` (else ``spawn``;
a forked child of a process that has initialised CUDA cannot use it),
or in a thread pool (``thread_pool=True``, or when the dataset cannot be
sent to a process). Workers never touch CUDA: they return numpy samples,
and the main process batches them into CPU NDArrays. ``pin_memory=True``
pins those batches (``Tensor.pin_memory()``), so a copy to the card can
run asynchronously; ``device_prefetch=N`` stages the next ``N`` batches
onto the card from a background thread on a stream of its own
(:class:`~.prefetch.DevicePrefetchIter`). Without it batches stay on the
host, and the caller moves them (``as_in_context``, ``split_and_load``).
"""
from __future__ import annotations

import multiprocessing
import warnings

import numpy as np
import torch

from ...ndarray.ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def _host_array(a):
    a = np.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    return NDArray(t)


def default_batchify_fn(data):
    """Stack samples into a batch of CPU NDArrays (a tuple sample gives a
    list of batches, one per element); float64 becomes float32, as
    ``nd.array`` does."""
    if isinstance(data[0], NDArray):
        return _host_array(np.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], torch.Tensor):
        return _host_array(np.stack([d.detach().cpu().numpy()
                                     for d in data]))
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    return _host_array(np.asarray(data))


# samples cross from the workers as numpy arrays: the same function
default_mp_batchify_fn = default_batchify_fn


def _as_numpy_sample(sample):
    if isinstance(sample, NDArray):
        return sample.asnumpy()
    if isinstance(sample, torch.Tensor):
        return sample.detach().cpu().numpy()
    if isinstance(sample, tuple):
        return tuple(_as_numpy_sample(s) for s in sample)
    return sample


def _pin(batch):
    if isinstance(batch, NDArray):
        return NDArray(batch._data.pin_memory())
    if isinstance(batch, torch.Tensor):
        return batch.pin_memory()
    if isinstance(batch, (list, tuple)):
        return type(batch)(_pin(b) for b in batch)
    if isinstance(batch, dict):
        return {k: _pin(v) for k, v in batch.items()}
    return batch


class _WorkerInitializer:
    """The dataset of a worker process (one copy a process; a thread pool
    uses :class:`_ThreadFetcher` instead)."""
    _dataset = None

    @staticmethod
    def init(dataset):
        _WorkerInitializer._dataset = dataset


def _worker_fetch(indices):
    ds = _WorkerInitializer._dataset
    return [_as_numpy_sample(ds[i]) for i in indices]


def _preload_in_forkserver():
    """Have the forkserver import this module, and so torch, once before
    it starts: each worker is then a fork of a process that holds them,
    not a fresh import of its own (seconds a worker, which the parent
    waits out while it sends a dataset larger than a pipe's buffer).
    Importing torch does not initialise CUDA. No effect once the server
    runs."""
    from multiprocessing import forkserver
    mods = list(getattr(forkserver._forkserver, "_preload_modules",
                        ["__main__"]))
    if __name__ not in mods:
        forkserver.set_forkserver_preload(mods + [__name__])


class _ThreadFetcher:
    def __init__(self, dataset):
        self._dataset = dataset

    def __call__(self, indices):
        return [_as_numpy_sample(self._dataset[i]) for i in indices]


class DataLoader:
    """Mini-batches of a Dataset.

    ``prefetch`` counts the batches requested ahead from the workers
    (default ``2 * num_workers``); with ``num_workers=0`` an explicit
    value runs a host thread that batches ahead. ``device_prefetch``
    (default ``MXNET_TPU_DATA_PREFETCH``, 0 = off) stages that many
    batches onto the device ahead of the consumer: the innermost ``with
    Context`` block's device when iteration starts, else the card
    (``pin_device_id``'s card when ``pin_memory``). ``timeout`` bounds the
    wait for one worker batch, in seconds; an exception a worker raises
    surfaces in the consumer.
    """

    def __init__(self, dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0, pin_memory=False,
                 pin_device_id=0, prefetch=None, thread_pool=False,
                 timeout=120, device_prefetch=None):
        if pin_memory and not torch.cuda.is_available():
            raise RuntimeError("pin_memory=True needs CUDA: pinned host "
                               "memory is the card's")
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._pin_device_id = pin_device_id
        self._thread_pool = thread_pool
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is "
                    "specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        from .prefetch import default_prefetch_depth
        self._device_prefetch = max(0, device_prefetch
                                    if device_prefetch is not None
                                    else default_prefetch_depth())
        self._pool = None
        self._fetch = _ThreadFetcher(dataset)
        if self._num_workers > 0:
            self._pool = (self._thread_pool_of(self._num_workers)
                          if thread_pool else self._process_pool())

    @staticmethod
    def _thread_pool_of(n):
        from multiprocessing.dummy import Pool as ThreadPool
        return ThreadPool(n)

    def _process_pool(self):
        # forkserver first: its server starts clean, so no child is a
        # fork of this (possibly CUDA-initialised, multithreaded) process
        # and an unguarded __main__ is not re-run in each worker as under
        # spawn; a thread pool when the dataset cannot be pickled
        err = None
        for method in ("forkserver", "spawn"):
            if method not in multiprocessing.get_all_start_methods():
                continue
            if method == "forkserver":
                _preload_in_forkserver()
            try:
                pool = multiprocessing.get_context(method).Pool(
                    self._num_workers, initializer=_WorkerInitializer.init,
                    initargs=(self._dataset,))
            except Exception as e:  # noqa: BLE001 - the next method
                err = e
                continue
            self._fetch = _worker_fetch
            return pool
        warnings.warn(f"dataset cannot be sent to worker processes "
                      f"({err!r}); DataLoader falls back to a thread pool",
                      stacklevel=3)
        return self._thread_pool_of(self._num_workers)

    def __iter__(self):
        batches = self._iter_batches()
        if self._device_prefetch > 0:
            from ...context import Context, gpu
            from .prefetch import DevicePrefetchIter
            ctx = Context.innermost()
            if ctx is None and self._pin_memory:
                ctx = gpu(self._pin_device_id)
            batches = iter(DevicePrefetchIter(
                batches, depth=self._device_prefetch, ctx=ctx))
        elif self._pool is None and self._prefetch > 0:
            from .prefetch import DevicePrefetchIter
            batches = iter(DevicePrefetchIter(
                batches, depth=self._prefetch, stage=False))
        yield from batches

    def _batch(self, samples):
        batch = self._batchify_fn(samples)
        return _pin(batch) if self._pin_memory else batch

    def _iter_batches(self):
        if self._pool is None:
            for batch_idx in self._batch_sampler:
                yield self._batch([self._dataset[i] for i in batch_idx])
            return
        batches = iter(self._batch_sampler)
        inflight = []
        for _ in range(max(1, self._prefetch)):
            idx = next(batches, None)
            if idx is None:
                break
            inflight.append(self._pool.apply_async(self._fetch, (idx,)))
        while inflight:
            samples = inflight.pop(0).get(self._timeout)
            idx = next(batches, None)
            if idx is not None:
                inflight.append(self._pool.apply_async(self._fetch, (idx,)))
            yield self._batch(samples)

    def __len__(self):
        return len(self._batch_sampler)

    def close(self):
        """Stop the worker pool (also done when the loader is
        collected)."""
        pool, self._pool = getattr(self, "_pool", None), None
        if pool is not None:
            pool.terminate()
            pool.join()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass

"""DevicePrefetchIter of the port (mirrors
``mxnet_tpu/gluon/data/prefetch.py``): a background thread stages
batches onto the device, ``depth`` batches ahead of the consumer.

On the card the producer copies each batch with ``non_blocking=True`` on
a CUDA stream of its own and records an event after the copies; the
consumer's stream waits on that event before the batch is handed out,
and every staged tensor is marked used on the consumer's stream
(``record_stream``), so the caching allocator does not reuse its memory
for the producer's next batch while the consumer's work may still read
it. Copies from pinned host memory (``DataLoader(pin_memory=True)``)
then overlap the consumer's work. On the CPU staging is a ``to``.

Batches come out in the source's order, and an exception the source
raises surfaces in the consumer where it occurred. The
``mxtpu_data_prefetch_*`` series on the port's metrics registry count
staged batches, the configured depth, the queue's fill at each read and
the consumer's wait.
"""
from __future__ import annotations

import os
import queue
import threading
import time

import torch

from ..._device import resolve_device
from ...ndarray.ndarray import NDArray

__all__ = ["DevicePrefetchIter", "stage_batch", "default_prefetch_depth"]

_DONE = object()


def default_prefetch_depth():
    """The ambient device-prefetch depth: ``MXNET_TPU_DATA_PREFETCH``
    (batches); 0 or unset is off."""
    try:
        return max(0, int(os.environ.get("MXNET_TPU_DATA_PREFETCH", "0")
                          or 0))
    except ValueError:
        return 0


def stage_batch(batch, device=None):
    """The NDArray and tensor leaves of ``batch`` (lists, tuples, dicts
    and ``DataBatch``-like objects with ``data``/``label`` lists) copied
    to ``device`` (a Context, string or ``torch.device``; default: the
    innermost ``with Context`` block's, else the card). Other leaves and
    sparse arrays pass through untouched: staging changes where arrays
    live, not what the consumer receives."""
    if not isinstance(device, torch.device):
        device = resolve_device(device)
    return _stage(batch, device, False, None)


def _stage(batch, device, non_blocking, staged):
    def rec(b):
        return _stage(b, device, non_blocking, staged)
    if isinstance(batch, NDArray):
        from ...ndarray.sparse import BaseSparseNDArray
        if isinstance(batch, BaseSparseNDArray):
            return batch   # reading ._data would densify it
        return NDArray(rec(batch._data))
    if isinstance(batch, torch.Tensor):
        out = batch.to(device, non_blocking=non_blocking)
        if staged is not None and out is not batch:
            staged.append(out)
        return out
    if isinstance(batch, (list, tuple)):
        return type(batch)(rec(b) for b in batch)
    if isinstance(batch, dict):
        return {k: rec(v) for k, v in batch.items()}
    data = getattr(batch, "data", None)
    if isinstance(data, (list, tuple)):
        label = getattr(batch, "label", None)
        batch.data = [rec(d) for d in data]
        if isinstance(label, (list, tuple)):
            batch.label = [rec(lb) for lb in label]
    return batch


def _metrics():
    from ...observability import get_registry
    reg = get_registry()
    return {
        "batches": reg.counter(
            "mxtpu_data_prefetch_batches_total",
            "Batches staged onto device by a prefetch thread."),
        "depth": reg.gauge(
            "mxtpu_data_prefetch_depth",
            "Configured double-buffer depth of the newest prefetcher."),
        "fill": reg.gauge(
            "mxtpu_data_prefetch_queue_fill",
            "Staged batches waiting at the last consumer read (0 = the "
            "consumer is data-bound, depth = fully hidden)."),
        "wait": reg.histogram(
            "mxtpu_data_prefetch_wait_seconds",
            "Consumer time blocked waiting for a staged batch."),
    }


class DevicePrefetchIter:
    """Any batch iterable with background staging onto ``ctx``.

    ``depth``: queue depth in batches (default ``MXNET_TPU_DATA_PREFETCH``
    or 2). ``ctx``: a Context, string or ``torch.device`` (default: the
    innermost ``with Context`` block's when this is made, else the
    card). ``stage=False`` makes it a host-side prefetch thread only (no
    copies, no metrics): ``DataLoader(prefetch=N, num_workers=0)``.
    """

    def __init__(self, source, depth=None, ctx=None, stage=True):
        if depth is None:
            depth = default_prefetch_depth() or 2
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._source = source
        self._depth = depth
        self._stage = stage
        self._device = resolve_device(ctx) if stage else None
        self._obs = _metrics() if stage else None
        if self._obs is not None:
            self._obs["depth"].set(depth)

    def __iter__(self):
        q = queue.Queue(maxsize=self._depth)
        stop = threading.Event()
        src = iter(self._source)
        device, do_stage, obs = self._device, self._stage, self._obs
        cuda = do_stage and device.type == "cuda"
        from ...observability.tracing import get_tracer
        tracer = get_tracer()
        # the staging spans parent under the consumer's span at the start
        parent = tracer.current()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                stream = torch.cuda.Stream(device) if cuda else None
                for item in src:
                    event = staged = None
                    if do_stage:
                        with tracer.span("mxtpu.data_prefetch.stage",
                                         "data", parent):
                            if cuda:
                                staged = []
                                with torch.cuda.stream(stream):
                                    item = _stage(item, device, True,
                                                  staged)
                                    event = torch.cuda.Event()
                                    event.record(stream)
                            else:
                                item = _stage(item, device, False, None)
                        obs["batches"].inc()
                    if not put((item, event, staged)):
                        return
                item = _DONE
            except BaseException as e:  # noqa: BLE001 - to the consumer
                item = e
            put(item)

        worker = threading.Thread(target=producer, daemon=True,
                                  name="mxtpu-device-prefetch")
        worker.start()
        try:
            while True:
                t0 = time.monotonic()
                item = q.get()
                if obs is not None:
                    obs["wait"].observe(time.monotonic() - t0)
                    obs["fill"].set(q.qsize())
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                item, event, staged = item
                if event is not None:
                    consumer = torch.cuda.current_stream(device)
                    consumer.wait_event(event)
                    for t in staged:
                        t.record_stream(consumer)
                yield item
        finally:
            # the consumer stopped (end, break, exception, collection):
            # release the producer
            stop.set()

    def __len__(self):
        return len(self._source)

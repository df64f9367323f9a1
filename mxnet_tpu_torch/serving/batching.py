"""Dynamic micro-batching queue of the port (mirrors
``mxnet_tpu/serving/batching.py``): coalesce concurrent single requests.

Requests arrive one at a time from many threads; the card wants
them in batches. The queue admits single-item requests and a worker
pops *micro-batches*: it blocks until at least one request is waiting,
then keeps collecting until either ``max_batch`` items are in hand or
``max_delay`` has elapsed since the oldest waiting request was enqueued
(the TensorFlow-Serving batching discipline: batch_timeout_micros +
max_batch_size — which pairs batching with BOUNDED queues and
rejection: see ``max_depth``). Under load the delay never binds —
batches fill instantly; at low rate a lone request waits at most
``max_delay``.

Each request carries a :class:`concurrent.futures.Future`; the worker
resolves it with the request's output rows (or an exception), so
callers block only on their own result, never on the batch.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from concurrent.futures import Future

from .errors import Overloaded, ServerClosed

__all__ = ["ServerClosed", "Overloaded", "Request", "MicroBatchQueue"]

# process-wide request ids (monotonic, never reused): the correlation
# key a request's tracer span and event-log records carry end to end
_request_ids = itertools.count(1)


class Request:
    __slots__ = ("x", "future", "t_enqueue", "t_dequeue", "rid", "span",
                 "deadline", "tenant")

    def __init__(self, x, deadline=None, tenant=None):
        self.x = x
        self.future = Future()
        self.t_enqueue = time.monotonic()
        self.t_dequeue = None
        self.rid = next(_request_ids)
        # a tracer hand-off span the server attaches at submit time and
        # finishes (on the worker thread) when the future resolves
        self.span = None
        # absolute monotonic end-to-end deadline (None = unbounded);
        # the worker fails an expired request BEFORE dispatching it
        self.deadline = deadline
        # optional tenant attribution label (None = untagged); rides
        # to the outcome paths so per-tenant served/shed/expired land
        # on mxtpu_serving_tenant_requests_total
        self.tenant = tenant

    def expired(self, now=None):
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= self.deadline

    @property
    def wait_s(self):
        """Queue time: enqueue -> picked into a micro-batch."""
        if self.t_dequeue is None:
            return 0.0
        return self.t_dequeue - self.t_enqueue


class MicroBatchQueue:
    """Thread-safe FIFO with micro-batch pop semantics.

    ``max_depth`` bounds the queue (admission control): past it,
    ``enqueue`` fails fast with :class:`Overloaded` instead of growing
    the backlog — under sustained overload a bounded queue sheds load
    at submit time rather than queueing every request into a deadline
    it can no longer meet. ``None``/0 = unbounded (the historical
    behavior)."""

    def __init__(self, max_depth=None):
        self._lock = threading.Lock()
        self._q = collections.deque()         # guarded-by: _lock
        self._nonempty = threading.Condition(self._lock)
        self._closed = False                  # guarded-by: _lock
        self.max_depth = int(max_depth) if max_depth else None

    # -------------------------------------------------------- producer --
    def submit(self, x):
        """Enqueue one request; returns its Future."""
        return self.submit_request(x).future

    def submit_request(self, x):
        """Enqueue one request; returns the Request itself."""
        req = Request(x)
        self.enqueue(req)
        return req

    def enqueue(self, req):
        """Admit a pre-built Request (the server constructs it first so
        its tracing span is attached BEFORE the worker can pop it)."""
        with self._lock:
            if self._closed:
                raise ServerClosed(
                    "server is draining; no new requests admitted")
            if (self.max_depth is not None
                    and len(self._q) >= self.max_depth):
                raise Overloaded(
                    f"queue full ({len(self._q)} >= max_depth "
                    f"{self.max_depth}); request shed",
                    reason="queue_full", depth=len(self._q))
            self._q.append(req)
            self._nonempty.notify_all()
        return req.future

    # -------------------------------------------------------- consumer --
    def get_batch(self, max_batch, max_delay_s):
        """Pop the next micro-batch (list of Requests).

        Blocks until at least one request is available, then waits up to
        ``max_delay_s`` past the OLDEST request's enqueue time for the
        batch to fill to ``max_batch``. Returns ``[]`` only when the
        queue is closed and empty — the worker's exit signal.
        """
        with self._lock:
            while not self._q:
                if self._closed:
                    return []
                # untimed: submit() and close() both notify under this
                # lock, so no wakeup can be missed and an idle worker
                # sleeps instead of polling
                self._nonempty.wait()
            deadline = self._q[0].t_enqueue + max_delay_s
            while len(self._q) < max_batch and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._nonempty.wait(timeout=remaining)
            n = min(len(self._q), max_batch)
            now = time.monotonic()
            batch = []
            for _ in range(n):
                req = self._q.popleft()
                req.t_dequeue = now
                batch.append(req)
            return batch

    # ----------------------------------------------------------- state --
    def close(self):
        """Stop admitting; queued requests still get served."""
        with self._lock:
            self._closed = True
            self._nonempty.notify_all()

    @property
    def closed(self):
        with self._lock:
            return self._closed

    def depth(self):
        with self._lock:
            return len(self._q)

    def drain(self):
        """Pop and return every queued request (worker-death cleanup:
        the server fails them typed so no Future is silently lost)."""
        with self._lock:
            out = list(self._q)
            self._q.clear()
            return out

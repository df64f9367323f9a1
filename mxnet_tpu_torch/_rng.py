"""Process RNG state of the port (mirrors ``mxnet_tpu/_rng.py``).

The state is ``(seed, draw position)``, as the reference's: every draw
takes the next position under a lock, so two threads never share one
and a process restored with :func:`set_state` replays the same stream.
A draw is one explicit ``torch.Generator`` on the draw's device, seeded
from ``(seed, position)`` (:func:`next_generator`): nothing reads or
moves torch's global generators, and no generator is shared between
draws. JAX's threefry bits are not reproduced: a seed gives the same
stream in this package on one device, not the JAX package's numbers.

A compiled region (a hybridized block's CUDA graph, a compiled training
step) draws from one generator of its own instead, the counterpart of
the reference's ``push_trace_key``/``pop_trace_key``: between
:func:`push_trace_generator` and :func:`pop_trace_generator`, every draw
on this thread through :func:`next_generator` (``nd.Dropout``,
``nd.random.*`` inside a block) takes the pushed generator and reserves
no position. A generator seeded on the host per draw would be frozen
into a graph at its capture, so every replay would draw the capture's
numbers; the pushed generator is registered with the graph
(``CUDAGraph.register_generator_state``), so each replay advances its
Philox offset and draws anew. The region itself advances the draw
position once per call (:func:`reserve_draw`), as the reference's step
takes one key a call, so a checkpoint's RNG entry keeps its meaning.
gluon's ``nn.Dropout`` draws from torch's default generator of the
device (``ops/nn.py`` ``Dropout``), which a capture registers itself.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["seed", "get_state", "set_state", "next_generator",
           "reserve_draw", "host_rng", "push_trace_generator",
           "pop_trace_generator"]

_MASK64 = (1 << 64) - 1


class _Counter:
    """A draw counter with a readable position, advanced under a lock: a
    Python read-modify-write is not atomic under the GIL, and concurrent
    draws must never get the same position."""

    __slots__ = ("value", "_lock")

    def __init__(self, start=0):
        self.value = start
        self._lock = threading.Lock()

    def __next__(self):
        with self._lock:
            v = self.value
            self.value += 1
        return v

    def __iter__(self):
        return self


_seed = 0
_counter = _Counter()
_host_rng = None
# the generator of the compiled region running on this thread, if any
_trace = threading.local()


def seed(seed_state: int, ctx=None):
    """Seed the process RNG (``mx.random.seed``): the draw position goes
    back to 0 and the host generator of the initializers is re-seeded.
    ``ctx`` is accepted for the reference's signature; a draw's stream
    depends on its position, not on a device's state."""
    global _seed, _counter, _host_rng
    _seed = int(seed_state)
    _counter = _Counter()
    _host_rng = None


def get_state():
    """The RNG's state for a checkpoint: ``{"seed", "draws"}``."""
    return {"seed": _seed, "draws": _counter.value}


def set_state(state):
    """Restore a state taken by :func:`get_state`."""
    seed(int(state["seed"]))
    _counter.value = int(state["draws"])


def reserve_draw():
    """Take the next draw position (host arithmetic only)."""
    return next(_counter)


def _mix(x):
    """splitmix64's finaliser: a 64-bit hash of ``x``."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def generator_for(seed_state, position, device="cpu"):
    """The generator of draw ``position`` under ``seed_state`` on
    ``device``: a fresh ``torch.Generator`` seeded from both."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(_mix(_mix(int(seed_state) & _MASK64) ^ int(position))
                    & ((1 << 63) - 1))
    return gen


def next_generator(device="cpu"):
    """A generator for the next draw, on ``device``: inside a compiled
    region on this thread, the region's generator (if it is on
    ``device``)."""
    gen = getattr(_trace, "gen", None)
    if gen is not None:
        want = torch.device(device)
        if gen.device.type == want.type and want.index in (
                None, gen.device.index):
            return gen
    return generator_for(_seed, reserve_draw(), device)


def push_trace_generator(gen):
    """Make ``gen`` the generator of every draw on this thread until
    :func:`pop_trace_generator`; returns the one it replaces."""
    old = getattr(_trace, "gen", None)
    _trace.gen = gen
    return old


def pop_trace_generator(old):
    """Restore the generator :func:`push_trace_generator` replaced."""
    _trace.gen = old


def host_rng():
    """A numpy ``RandomState`` for host-side draws, seeded by
    :func:`seed` (the initializers' stream, apart from user code's)."""
    global _host_rng
    if _host_rng is None:
        _host_rng = np.random.RandomState(_seed & 0xFFFFFFFF)
    return _host_rng

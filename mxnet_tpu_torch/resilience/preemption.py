"""Preemption handling: turn SIGTERM/SIGINT into a checkpoint-and-exit
(the port of ``mxnet_tpu/resilience/preemption.py``).

Preemptible machines are reclaimed with a SIGTERM and a short grace
window. A
signal handler must not checkpoint *in* the handler (it may interrupt a
step mid-flight, and most of this stack is not async-signal-safe), so
:class:`PreemptionGuard` only sets a flag; the training loop polls it at
step boundaries — the only points where params/optimizer state are
consistent — and performs the final checkpoint itself.
"""
from __future__ import annotations

import signal
import threading

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Installs handlers for ``signals`` that set a sticky flag.

    Usage::

        with PreemptionGuard() as guard:
            for batch in data:
                trainer.step(...)
                if guard.requested:
                    trainer.save_state(ckpt_dir)
                    break

    The previous handlers are chained (called after the flag is set) and
    restored on uninstall, so the guard composes with launchers that
    have their own SIGTERM logic. ``callback`` (if given) runs in the
    handler — keep it trivial (logging, setting more flags).
    Thread-safe to poll; install/uninstall must happen on the main
    thread (a CPython signal rule).
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT),
                 callback=None):
        self._signals = tuple(signals)
        self._callback = callback
        self._callbacks = []
        self._event = threading.Event()
        self._prev = {}
        self._installed = False
        self.signum = None

    def add_callback(self, fn):
        """Register an extra ``fn(signum)`` to run when a watched signal
        lands. Same rule as the constructor ``callback``: it executes
        INSIDE the signal handler, so it must be trivial and must not
        take locks (set a flag, bump a counter). Consumers that need
        real work on preemption — e.g. the graceful drain of
        ``LLMServer.attach_preemption_guard`` — should instead poll
        :attr:`requested` / :meth:`wait` from their own thread. Returns
        ``fn`` so it can be used as a decorator."""
        self._callbacks.append(fn)
        return fn

    def remove_callback(self, fn):
        try:
            self._callbacks.remove(fn)
        except ValueError:
            pass

    # --------------------------------------------------------- install --
    def install(self):
        if self._installed:
            return self
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handle)
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    def _handle(self, signum, frame):
        self.signum = signum
        self._event.set()
        if self._callback is not None:
            self._callback(signum)
        for fn in tuple(self._callbacks):
            fn(signum)
        prev = self._prev.get(signum)
        # default_int_handler raises KeyboardInterrupt at the interrupted
        # instruction — chaining it would abort mid-step, defeating the
        # poll-at-step-boundary design; treat it like SIG_DFL
        if callable(prev) and prev not in (
                signal.SIG_IGN, signal.SIG_DFL,
                signal.default_int_handler):
            prev(signum, frame)

    # ----------------------------------------------------------- state --
    @property
    def requested(self) -> bool:
        """True once any watched signal has been received (sticky)."""
        return self._event.is_set()

    def clear(self):
        self._event.clear()
        self.signum = None

    def wait(self, timeout=None) -> bool:
        return self._event.wait(timeout)

"""mx.monitor — training-time tensor inspection (the port of
``mxnet_tpu/monitor.py``).

Reference: python/mxnet/monitor.py:32 (Monitor installs a stat callback
on every executor output and prints aggregated stats per step). Here the
same surface rides the gluon Block forward hooks: ``install(block)``
hooks a block tree, ``tic()``/``toc()`` bracket a step, and
``toc_print()`` prints ``(step, name, stat)`` rows. The default stat is
the reference's |x|/size norm, on a host numpy copy of each output (a
bf16/f16 tensor widened to f32, as ``metric._as_numpy`` does).
"""
from __future__ import annotations

import logging
import re

import numpy as _np

from .metric import _as_numpy, _is_array

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, interval=1, stat_func=None, pattern=".*",
                 sort=False):
        self.interval = int(interval)
        self.stat_func = stat_func or (
            lambda x: _np.abs(x).sum() / x.size)   # reference default
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.step = 0
        self.activated = False
        self.queue = []
        self._handles = []

    # -- installation ------------------------------------------------------
    def install(self, block):
        """Hook a Block (and all children) so forward outputs are
        recorded while activated (reference: Monitor.install wraps the
        executor's monitor_callback)."""
        for name, child in self._walk(block):
            h = child.register_forward_hook(
                lambda blk, args, out, _n=name: self._record(_n, out))
            self._handles.append(h)
        return self

    def _walk(self, block, prefix=""):
        from .gluon.block import Block
        yield (prefix + (block.name or block.__class__.__name__), block)
        for cname, child in block._modules.items():
            if isinstance(child, Block):
                yield from self._walk(child, prefix + cname + ".")

    def _record(self, name, out):
        if not self.activated or not self.re_pattern.match(name):
            return
        outs = out if isinstance(out, (list, tuple)) else [out]
        for i, o in enumerate(outs):
            if not _is_array(o):
                continue
            arr = _as_numpy(o)
            key = name if len(outs) == 1 else f"{name}_output{i}"
            self.queue.append((self.step, key, self.stat_func(arr)))

    # -- step bracketing ---------------------------------------------------
    def tic(self):
        if self.step % self.interval == 0:
            self.activated = True
            self.queue = []

    def toc(self):
        """Deactivate and return the collected (step, name, stat) rows."""
        if not self.activated:
            self.step += 1
            return []
        self.activated = False
        res = list(self.queue)
        if self.sort:
            res.sort(key=lambda r: r[1])
        self.queue = []
        self.step += 1
        return res

    def toc_print(self):
        for step, name, stat in self.toc():
            logging.info("Batch: %7d %30s %s", step, name, stat)

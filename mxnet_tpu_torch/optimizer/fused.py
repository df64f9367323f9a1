"""The whole optimizer step over a Trainer's parameters as one launch of
the multi-tensor update kernel per (op, dtype) group (mirrors
``mxnet_tpu/optimizer/fused.py``).

The port's per-parameter loop launches one update kernel per parameter
(about 200 for BERT-base). This module applies the same step as one
launch of ``csrc/multi_tensor_update.cu`` for each (update op, weight
dtype) pair the step uses: one launch for an all-f32 Adam model,
whatever its parameter count. It is the port's counterpart of the
reference's one-dispatch fused apply and of MXNet's multi-tensor
``multi_sgd_*`` kernels.

How it stays bit-exact with the loop
------------------------------------
Each step the per-parameter updater runs once in *record mode*: the
``ops.invoke`` chokepoint hands each update op's call (op, the roles of
its tensors, its kwargs) to a recorder instead of running it. All host
bookkeeping (update counts, lr schedules, Adam's bias correction, lr/wd
multipliers, the loss scaler's rescale) runs exactly as in the loop, in
float64. The recorded calls are then replayed grouped by (op, weight
dtype): each group's per-parameter scalars (and gradient addresses:
autograd hands out new gradient tensors every backward) become 64-byte
rows of one table copied once a step from a persistent pinned buffer
into the program's persistent device buffer (:class:`RowBuffer`), for
all groups, and each group is one launch over a table of the weights' and
states' pointers and sizes that is kept while those ``data_ptr``s and
sizes stay the same (the update is in place, so they stay put). The
loop launches the same kernel over one parameter with the same row, so
both give the same bits; on the CPU both run the op's twin with the
same Python scalars.

The recorded program is cached on (optimizer class, the recorded ops
with their static kwargs and tensor roles, the weights' dtypes); lr, wd,
momentum and rescale_grad (``invoke.TRACED_HYPERPARAMS``) change every
step without a new program, and nothing is ever compiled after the
kernel's first build.

Fallbacks to the loop, each with its reason label (``Trainer`` counts
them in ``FusedUpdater.fallbacks``): ``env_disabled``
(``MXNET_TPU_FUSED_UPDATE=0``), ``ignore_stale_grad``, ``optimizer`` (an
optimizer outside the fusable set — the eleven whose update is tensor
arithmetic or needs a norm between two ops are not in it, as in the
reference — or generic multi-precision, whose
master-weight casts happen outside the op chokepoint), ``unrecordable``
(an update op touched a tensor that is not the parameter's weight,
gradient or state, or took a tensor or int static hyperparameter) and
``aliased`` (two parameters' tensors overlap in memory, found by their
``data_ptr`` ranges: one launch would update them in a race). A kernel
that fails to build or launch raises; it never gives way to the loop.

A step where any gradient is row-sparse (``Embedding(sparse_grad=True)``)
falls back with ``sparse_grad``: the loop hands the RowSparseNDArray to
the optimizer (SGD's and Adam's lazy updates). The reference's
``fold_reduce`` (the gradient sum across device replicas folded into
the update) and its multi-context replicas have no counterpart on one
device and are left out.

The counterpart of its ``bind_entries``/``apply_entries`` (the update
folded into ``jit.CompiledTrainStep``'s program) is the same split used
inside a CUDA graph: the step's :meth:`FusedUpdater.record` runs on the
host every call, the rows it yields are written to the program's
:class:`RowBuffer` before the replay, and the captured
:meth:`_Program.launch` reads them there. Inside a graph the gradients
come from the graph's pool and keep their addresses, so the rows carry
the same gradient addresses every step.
"""
from __future__ import annotations

import collections
import os

import numpy as np

from ..observability.tracing import get_tracer
from ..ops import invoke as _invoke
from ..ops import optimizer_ops as _ops
from . import optimizer as _opt

__all__ = ["FusedUpdater", "Recorded", "RowBuffer", "fusable",
           "prepare_states", "build_roles", "record_program",
           "rollback_counts"]

# Optimizers whose update is one registered update op per parameter,
# with no host sync and no per-call Python state: the recorded program
# describes the step completely.
_FUSABLE_TYPES = (_opt.SGD, _opt.NAG, _opt.Adam, _opt.AdamW, _opt.AdaGrad,
                  _opt.RMSProp, _opt.Ftrl, _opt.Signum, _opt.SignSGD)


def fusable(optimizer):
    """True when this optimizer instance may take the fused path."""
    if type(optimizer) not in _FUSABLE_TYPES:
        return False
    if optimizer.multi_precision and type(optimizer) is not _opt.SGD:
        # the generic mp path casts master weights outside apply_op; only
        # SGD updates 16-bit weights through its own ops (mp_sgd_*)
        return False
    return True


class _Recorder:
    """Captures each update op's call as (op name, input roles, static
    kwargs), with its kwargs. ``roles`` maps id(tensor) -> ('w'|'g'|'s',
    position)."""

    def __init__(self, roles):
        self.roles = roles
        self.program = []       # (op_name, roles, static kwargs)
        self.params = []        # each call's kwargs
        self.ok = True

    def record(self, op, inputs, params):
        entry_roles = []
        for x in inputs:
            r = self.roles.get(id(x))
            if r is None:
                self.ok = False  # the op touched a tensor we don't track
            entry_roles.append(r)
        static_kw, _, _ = _invoke._split_hyper(params)
        for _, v in static_kw:
            if _invoke._is_dynamic(v):
                self.ok = False
            if isinstance(v, int) and not isinstance(v, bool):
                self.ok = False  # a per-step int would key a program a step
        self.program.append((op.name, tuple(entry_roles), static_kw))
        self.params.append(params)
        results = [inputs[m] for m in op.mutates]
        return results[0] if len(results) == 1 else tuple(results)


def _leaves(state):
    """The tensors of a state tree, in order (None contributes none)."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [leaf for s in state for leaf in _leaves(s)]
    return [state]


def prepare_states(optimizer, updater, work):
    """Create (or move to their weights' device) the states of ``work``
    ([(index, Parameter)]) before the roles are built over them."""
    for i, param in work:
        w = param.data()
        if i not in updater.states:
            updater.states[i] = optimizer.create_state_multi_precision(i, w)
            updater.states_synced[i] = True
        elif not updater.states_synced[i]:
            updater.states[i] = updater.sync_state_context(
                updater.states[i], w.device)
            updater.states_synced[i] = True


def build_roles(updater, work, grads=None):
    """Map id(tensor) -> role for every weight, gradient and state of
    ``work``; ``grads`` (one a parameter) stand in for
    ``param.grad()``. Returns (roles, weights, grads, state leaves)."""
    roles = {}
    stand_in = grads
    weights, grads, leaves = [], [], []
    for k, (i, param) in enumerate(work):
        w = param.data()
        g = param.grad() if stand_in is None else stand_in[k]
        roles[id(w)] = ("w", k)
        roles[id(g)] = ("g", k)
        for leaf in _leaves(updater.states[i]):
            roles[id(leaf)] = ("s", len(leaves))
            leaves.append(leaf)
        weights.append(w)
        grads.append(g)
    return roles, weights, grads, leaves


def record_program(updater, work, grads, weights, roles):
    """Drive the per-parameter updater once with the op chokepoint in
    record mode: the host bookkeeping advances as in the loop, the
    device work is recorded. Returns the recorder (check ``.ok``; when
    it is not, the caller must :func:`rollback_counts`)."""
    rec = _Recorder(roles)
    _invoke._FUSED_RECORDER.rec = rec
    try:
        for k, (i, _) in enumerate(work):
            updater(i, grads[k], weights[k])
    finally:
        _invoke._FUSED_RECORDER.rec = None
    return rec


def rollback_counts(optimizer, work):
    """Undo the recording's count advance, so the loop that runs instead
    does not count the step twice."""
    for i, _ in work:
        if i in optimizer._index_update_count:
            optimizer._index_update_count[i] -= 1
    optimizer.num_update = max([optimizer.begin_num_update]
                               + list(optimizer._index_update_count.values()))


def _span(t):
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def _aliased(tensors):
    """True when two of ``tensors`` overlap in memory."""
    end = 0
    for start, stop in sorted(_span(t) for t in tensors if t.numel()):
        if start < end:
            return True
        end = max(end, stop)
    return False


class RowBuffer:
    """One program's scalar rows on the card, refreshed by one copy a
    step from a persistent pinned host buffer, so a launch captured in a
    CUDA graph reads each step's rows from the same address.

    Two pinned buffers take turns, each with the event of its last copy:
    a write waits for the copy two steps back, not for the step in
    flight. (A fresh pinned tensor a step, as ``ops.optimizer_ops.
    _upload`` makes, would be freed while a graph's captured copy still
    read it.) ``dev`` holds ``nfloats`` float32 words."""

    def __init__(self, nfloats, device):
        import torch
        self.device = device
        self.nfloats = nfloats
        self.dev = torch.zeros(nfloats, dtype=torch.float32, device=device)
        self._host = [torch.zeros(nfloats, dtype=torch.float32,
                                  pin_memory=True) for _ in range(2)]
        self._events = [None, None]
        self._turn = 0

    @property
    def ptr(self):
        return self.dev.data_ptr()

    def write(self, *parts):
        """Copy the float32 arrays ``parts``, back to back, to the
        front of ``dev`` on the current stream (one copy)."""
        import torch
        i, self._turn = self._turn, self._turn ^ 1
        if self._events[i] is not None:
            self._events[i].synchronize()
        host = self._host[i].numpy()
        n = 0
        for part in parts:
            flat = np.ascontiguousarray(part).reshape(-1).view(np.float32)
            host[n:n + flat.size] = flat
            n += flat.size
        self.dev[:n].copy_(self._host[i][:n], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._events[i] = ev


class _Program:
    """A recorded step grouped for replay: per (op, weight dtype) group
    the indices of its calls, in recording order; on the card, each
    group's launch table for the tensors' current layout and the rows'
    :class:`RowBuffer`."""

    def __init__(self, program, weights):
        groups = {}
        for e, (name, entry_roles, _) in enumerate(program):
            dtype = weights[entry_roles[0][1]].dtype
            groups.setdefault((name, dtype), []).append(e)
        self.groups = [(name, entries)
                       for (name, _), entries in groups.items()]
        self.roles = [entry_roles for _, entry_roles, _ in program]
        self.layout = None
        self.tables = None
        self.rows = None

    def inputs(self, entries, bufs):
        return [[bufs[r] for r in self.roles[e]] for e in entries]

    def apply_twin(self, bufs, params):
        """The step on the CPU: each group through the op's twin."""
        for name, entries in self.groups:
            _ops.multi_update(name, self.inputs(entries, bufs),
                              [params[e] for e in entries])

    def bind(self, bufs, layout, extra_rows=0):
        """Build the launch tables over ``bufs`` (a gradient's entry only
        sizes its check: each step's gradient addresses ride its rows)
        and the row buffer, with ``extra_rows`` rows of SCALAR_ROW words
        after the program's for the caller; unless ``layout`` is the one
        already bound. Returns the number of tables built."""
        if self.layout == layout:
            return 0
        self.tables = [_ops.UpdateTable(name, self.inputs(entries, bufs))
                       for name, entries in self.groups]
        nrows = sum(len(entries) for _, entries in self.groups)
        self.rows = RowBuffer((nrows + extra_rows) * _ops.SCALAR_ROW,
                              self.tables[0].device)
        self.layout = layout
        return len(self.tables)

    def scalar_rows(self, params, grads):
        """This step's rows for every group, in launch order, from the
        recorded calls' kwargs and the gradients ``grads`` (by the
        position of their parameter)."""
        return np.concatenate([
            table.rows([params[e] for e in entries],
                       [grads[self.roles[e][1][1]] for e in entries])
            for (_, entries), table in zip(self.groups, self.tables)])

    def launch(self):
        """One launch per group over the rows in :attr:`rows` (capturable:
        every address it passes stays put)."""
        offset = 0
        for (_, entries), table in zip(self.groups, self.tables):
            table.launch(self.rows.ptr + offset * 4 * _ops.SCALAR_ROW)
            offset += len(entries)


class Recorded:
    """A step's host record pass (:meth:`FusedUpdater.record`): the
    updated parameters ``work``, their weights, gradients and state
    leaves, the recorder (``rec.params``: each call's kwargs) and the
    program; ``bufs`` maps each role to its tensor."""

    __slots__ = ("work", "weights", "grads", "leaves", "rec", "prog",
                 "layout", "bufs")

    def __init__(self, work, weights, grads, leaves, rec, prog, layout):
        self.work, self.weights, self.grads = work, weights, grads
        self.leaves, self.rec, self.prog = leaves, rec, prog
        self.layout = layout
        self.bufs = {}
        for k, w in enumerate(weights):
            self.bufs[("w", k)] = w
            self.bufs[("g", k)] = grads[k]
        for j, leaf in enumerate(leaves):
            self.bufs[("s", j)] = leaf


class FusedUpdater:
    """One launch per (op, dtype) group for ``gluon.Trainer``'s step.

    ``step(params)`` applies the whole update and returns True, or
    returns False (reason in ``last_fallback_reason``) so the caller runs
    the per-parameter loop. It is two parts: :meth:`record`, the host
    pass (update counts, Adam's bias correction, lr/wd multipliers, the
    loss scaler's rescale, in f64) that yields the step's scalar rows,
    and the launch over the program's tables, which reads those rows
    from the program's :class:`RowBuffer` (one copy a step) and can be
    captured in a CUDA graph (``jit.CompiledTrainStep``).
    ``last_dispatches`` is the number of kernel launches (on the CPU:
    twin passes) of the last fused step; ``programs_built`` counts
    recorded programs and ``tables_built`` the launch tables uploaded,
    neither of which moves while the step's signature and tensors stay
    the same."""

    def __init__(self, optimizer, updater):
        self._optimizer = optimizer
        self._updater = updater
        self._cache = {}
        self._disabled = None   # sticky reason once found unrecordable
        self._layout = None     # the last layout seen, and whether it
        self._layout_aliased = False  # overlaps
        self.last_dispatches = 0
        self.last_fallback_reason = None
        self.programs_built = 0
        self.tables_built = 0
        self.fallbacks = collections.Counter()

    def why_ineligible(self, params, ignore_stale_grad):
        """None if the fused path may run now, else a reason label."""
        if os.environ.get("MXNET_TPU_FUSED_UPDATE", "1") == "0":
            return "env_disabled"
        if self._disabled is not None:
            return self._disabled
        if ignore_stale_grad:
            return "ignore_stale_grad"
        if not fusable(self._optimizer):
            return "optimizer"
        for p in params:
            if p.grad_req != "null" and p._data is not None and \
                    p._data.grad is not None and p._data.grad.is_sparse:
                return "sparse_grad"
        return None

    def record(self, params, grads=None, work=None):
        """The host record pass over ``params`` (or the ``work`` list of
        (index, Parameter) given): the bookkeeping advances as in the
        loop and the update ops are recorded. ``grads`` (one tensor per
        updated parameter) stand in for ``param.grad()``. Returns a
        :class:`Recorded`, None when there is nothing to update, or
        False (reason in ``last_fallback_reason``; counts rolled back)
        when the loop must run instead."""
        opt, upd = self._optimizer, self._updater
        self.last_fallback_reason = None
        if work is None:
            work = [(i, p) for i, p in enumerate(params)
                    if p.grad_req != "null" and p._data is not None]
        if not work:
            return None
        prepare_states(opt, upd, work)
        roles, weights, grads, leaves = build_roles(upd, work, grads)
        # the written tensors (weights, states) stay put between steps;
        # gradients are read only, and move (their addresses go with
        # each step's rows)
        layout = tuple((t.data_ptr(), t.numel()) for t in (*weights, *leaves))
        if layout != self._layout:
            self._layout = layout
            self._layout_aliased = _aliased(weights + leaves)
        if self._layout_aliased:
            self.last_fallback_reason = "aliased"
            return False
        rec = record_program(upd, work, grads, weights, roles)
        if not rec.ok:
            self._disabled = self.last_fallback_reason = "unrecordable"
            rollback_counts(opt, work)
            return False
        key = (type(opt), tuple(rec.program),
               tuple(w.dtype for w in weights))
        prog = self._cache.get(key)
        if prog is None:
            prog = self._cache[key] = _Program(rec.program, weights)
            self.programs_built += 1
        return Recorded(work, weights, grads, leaves, rec, prog, layout)

    def step(self, params):
        """Apply one fused update over ``params`` (a list of
        Parameters); False when the loop must run instead."""
        self.last_dispatches = 0
        r = self.record(params)
        if r is None:
            return True  # nothing to update: handled, no launch
        if r is False:
            return False
        prog = r.prog
        with get_tracer().span("mxtpu.fused_update.dispatch", "step"):
            if r.weights[0].device.type == "cpu":
                prog.apply_twin(r.bufs, r.rec.params)
            else:
                self.tables_built += prog.bind(r.bufs, r.layout)
                prog.rows.write(prog.scalar_rows(r.rec.params, r.grads))
                prog.launch()
        self.last_dispatches = len(prog.groups)
        return True

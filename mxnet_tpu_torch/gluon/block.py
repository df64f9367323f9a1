"""Gluon ``Block`` and ``HybridBlock`` of the port, on ``torch.nn.Module``
(mirrors ``mxnet_tpu/gluon/block.py``).

Names follow MXNet: every block gets a prefix from the enclosing
``name_scope()`` (``dense0_``, ``layer0_attn_query_`` ...) or from a
process-wide counter at the root, and its parameters are named
``prefix + name``; ``params=`` shares another block's ``ParameterDict``
and ``prefix=""`` takes the enclosing block's names (its ``name_scope``
adds none). A child block assigned as an attribute, or passed to
:meth:`Block.register_child`, is an ``nn.Module`` child; a
:class:`~.parameter.Parameter` assigned as an attribute stays reachable
as that attribute (``self.weight.data()``) and its tensor is registered
as the module's ``nn.Parameter`` of the same name once it exists.

Where ``torch.nn.Module`` has a method of the same name, the
reference's signature and semantics win: ``apply(fn)`` (children first,
then the block; returns it), ``zero_grad()`` (every gradient set to
zero in place), ``register_forward_pre_hook(hook)`` /
``register_forward_hook(hook)`` (``hook(block, inputs)`` /
``hook(block, inputs, output)``, return value ignored; the handle has
``detach()``) and ``__repr__``. Torch's own hooks stay reachable as
``torch.nn.Module.register_forward_hook(block, hook)``.

``save_parameters`` / ``load_parameters`` key each parameter by its
structural path (``features.0.weight``: attribute names and child
indices, :meth:`Block._collect_params_with_prefix`) in ``nd.save``'s
container, so a file written by either package loads into the other's
block of the same structure. ``HybridBlock.export`` writes the same
parameters keyed ``arg:``/``aux:`` (no graph JSON, as the JAX package
writes none); :class:`SymbolBlock` runs a Symbol graph as a block.

While ``mx.profiler`` captures with scopes on (``profiler.scopes_enabled``),
each block call runs inside a ``torch.profiler.record_function`` range
named after the block; off, the check is one flag read.
"""
from __future__ import annotations

import functools
import re
import threading
from collections import OrderedDict

import numpy as np
import torch

from .. import profiler as _profiler
from ..ndarray.ndarray import NDArray, unwrap
from ..ops import nn as _nn
from .parameter import DeferredInitializationError, Parameter, \
    ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock", "CachedOp"]


def _holds_ndarray(obj):
    """Whether an NDArray is among ``obj`` or inside its lists, tuples
    and dicts."""
    if isinstance(obj, NDArray):
        return True
    if isinstance(obj, dict):
        obj = obj.values()
    elif not isinstance(obj, (list, tuple)):
        return False
    return any(_holds_ndarray(v) for v in obj)


def ndarray_boundary(method):
    """A block method (``__call__``, a cell's ``unroll``) that computes on
    tensors: NDArray arguments are unwrapped, and a caller that passed an
    NDArray gets NDArrays back; tensor callers get tensors."""
    @functools.wraps(method)
    def call(self, *args, **kwargs):
        wrap = _holds_ndarray(args) or _holds_ndarray(kwargs)
        out = method(self, *unwrap(args), **unwrap(kwargs))
        return _as_ndarrays(out) if wrap else out
    return call


def _as_ndarrays(out):
    """``out`` with each tensor in it, alone or in nested lists and
    tuples, as an NDArray over that tensor (no copy)."""
    def mark(f):
        if isinstance(f, str):
            return "N" if f == "T" else f
        return f[0], tuple(mark(c) for c in f[1])
    leaves, fmt = _flatten(out)
    return _regroup(leaves, mark(fmt))


class _OpNamespace:
    """``F`` of ``hybrid_forward``, on tensors: the gluon functions of
    :mod:`mxnet_tpu_torch.ops.nn` (``FullyConnected``, ``Activation``,
    ``LayerNorm`` ...) with their signatures, and every other registered
    op by name with the reference's ``nd`` signature (``F.Convolution``,
    ``F.BatchNorm``, ``F.concat(a, b, dim=1)``, ``F.clip(x, 0, 6)``),
    through the op chokepoint and its AMP casts; tensors in, tensors
    out."""

    def __getattr__(self, name):
        if name in _nn.__all__:
            fn = getattr(_nn, name)
        else:
            from ..ndarray import register
            from ..ops.registry import _REGISTRY
            op = _REGISTRY.get(name)
            if op is None:
                raise AttributeError(f"F has no operator {name!r}")
            nd_fn = register.make_op_func(op)

            def fn(*args, **kwargs):
                return unwrap(nd_fn(*args, **kwargs))
            fn.__name__ = name
        setattr(self, name, fn)
        return fn


_F = _OpNamespace()


class _BlockScope:
    """Name scope for automatic ``prefix`` generation."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        """(prefix, ParameterDict) of a block made in the current scope;
        ``params`` (a ParameterDict) is shared."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _name_counter(hint) + "_"
            if params is None:
                return prefix, ParameterDict(prefix)
            return prefix, ParameterDict(params.prefix, shared=params)
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = f"{hint}{count}_"
            current._counter[hint] = count + 1
        if params is None:
            params = ParameterDict(current._block.params.prefix + prefix)
        else:
            params = ParameterDict(params.prefix, shared=params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


_GLOBAL_NAME_COUNTER = {}


def _name_counter(hint):
    count = _GLOBAL_NAME_COUNTER.get(hint, 0)
    _GLOBAL_NAME_COUNTER[hint] = count + 1
    return f"{hint}{count}"


def _profiled(call, name):
    """``call`` inside a ``torch.profiler.record_function`` range named
    ``name`` (the reference's ``jax.named_scope`` of a block)."""
    def run(*args, **kwargs):
        with torch.profiler.record_function(name):
            return call(*args, **kwargs)
    return run


class Block(torch.nn.Module):
    """Base building block: named parameters in ``self.params``, child
    blocks as ``nn.Module`` children, ``collect_params`` over the tree."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._reg_params = {}
        self._gluon_pre_hooks = OrderedDict()
        self._gluon_hooks = OrderedDict()

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        modstr = "\n".join(
            f"  ({key}): {_indent(repr(block), 2)}"
            for key, block in self._modules.items() if block is not None)
        return f"{self.__class__.__name__}(\n{modstr}\n)"

    @ndarray_boundary
    def __call__(self, *args, **kwargs):
        # NDArrays are unwrapped once, here (ndarray_boundary):
        # blocks compute on tensors, and a child called inside a forward
        # gets tensors, so only the outermost call hands NDArrays back
        call = self._forward_call()
        if _profiler._scopes_enabled:
            # a profiler capture: each block's forward is a named range
            call = _profiled(call, self.name or type(self).__name__)
        if not (self._gluon_pre_hooks or self._gluon_hooks):
            return call(*args, **kwargs)
        # hooks see every input: keyword inputs appended as a dict
        hook_args = args + (kwargs,) if kwargs else args
        for hook in list(self._gluon_pre_hooks.values()):
            hook(self, hook_args)
        out = call(*args, **kwargs)
        for hook in list(self._gluon_hooks.values()):
            hook(self, hook_args, out)
        return out

    def _forward_call(self):
        """What a call runs: ``torch.nn.Module``'s call of
        :meth:`forward` (a hybridized block: its :class:`CachedOp`)."""
        return super().__call__

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is None:
                raise AttributeError(
                    "cannot assign a Parameter before Block.__init__()")
            if name in reg and reg[name] is not value:
                raise TypeError("Overriding Parameter attribute is not "
                                "allowed.")
            reg[name] = value
            value._attach(self, name)
            return
        super().__setattr__(name, value)

    def __getattr__(self, name):
        reg = self.__dict__.get("_reg_params")
        if reg is not None and name in reg:
            return reg[name]
        return super().__getattr__(name)

    def _apply(self, fn, recurse=True):
        ret = super()._apply(fn, recurse)
        for name, param in self._reg_params.items():
            t = self._parameters.get(name)
            if t is not None and t is not param._data:
                param._adopt(t)
        return ret

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """The parameters of this block and every descendant, optionally
        only those whose name matches the regex ``select``."""
        ret = ParameterDict(self._params.prefix)
        pattern = re.compile(select) if select else None
        ret.update({name: value for name, value in self.params.items()
                    if pattern is None or pattern.match(name)})
        for child in self._children_blocks():
            ret.update(child.collect_params(select=select))
        return ret

    def _children_blocks(self):
        return [c for c in self._modules.values() if c is not None]

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._modules))
        self.add_module(name, block)

    def register_forward_pre_hook(self, hook):
        """``hook(block, inputs)`` before each forward; returns a handle
        whose ``detach()`` removes it."""
        return _HookHandle(self._gluon_pre_hooks, hook)

    def register_forward_hook(self, hook):
        """``hook(block, inputs, output)`` after each forward (its return
        value is ignored); returns a handle whose ``detach()`` removes
        it."""
        return _HookHandle(self._gluon_hooks, hook)

    def apply(self, fn):
        """``fn(block)`` on every descendant, children first, then on
        this block; returns this block."""
        for child in self._children_blocks():
            child.apply(fn)
        fn(self)
        return self

    def initialize(self, init=None, device=None, generator=None,
                   force_reinit=False, ctx=None, verbose=False):
        """Initialize every parameter of the tree on ``device`` (or
        ``ctx``, the reference's name: a Context, string or
        ``torch.device``; default: the innermost ``with Context``
        block's, else the card); ``init`` (default ``Uniform()``) serves
        parameters without their own initializer. Draws come from
        ``generator``. ``force_reinit`` draws initialized parameters anew
        (new tensors: the tree's CUDA graphs are dropped)."""
        self.collect_params().initialize(init, device, generator,
                                         force_reinit=force_reinit, ctx=ctx)
        if force_reinit:
            self._drop_graphs()

    def _drop_graphs(self):
        """Drop the CUDA graphs of every hybridized block of the tree:
        they replay on the parameters' addresses, which just changed."""
        def drop(block):
            if isinstance(block, HybridBlock):
                block._cached_op = None
        self.apply(drop)

    def cast(self, dtype):
        """Cast every parameter of the tree to ``dtype`` (see
        :meth:`.Parameter.cast`); drops the tree's CUDA graphs."""
        for child in self._children_blocks():
            child.cast(dtype)
        for param in self.params.values():
            param.cast(dtype)
        self._drop_graphs()

    def zero_grad(self):
        """Set every gradient of the tree to zero, in place."""
        self.collect_params().zero_grad()

    def reset_ctx(self, ctx):
        """Move every parameter of the tree to device ``ctx`` (dropping
        the tree's CUDA graphs)."""
        self.collect_params().reset_ctx(ctx)
        self._drop_graphs()

    # ------------------------------------------------------------- state --
    def save_parameters(self, filename, deduplicate=False):
        """Save the tree's parameters to ``filename`` (``nd.save``'s
        container, written atomically), keyed by structural path
        (:meth:`_collect_params_with_prefix`). Returns ``nd.save``'s
        metadata."""
        from ..ndarray import save as nd_save
        params = self._collect_params_with_prefix()
        return nd_save(filename, {key: val.data().detach()
                                  for key, val in params.items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a file of :meth:`save_parameters` (either package's)
        into the tree, onto device ``ctx`` for parameters without data
        yet (default: the card; initialized ones keep theirs). A file of
        full-prefix names (``ParameterDict.save``) loads through
        :meth:`.ParameterDict.load` with this block's prefix. A loaded
        value takes the parameter's dtype (``cast_dtype`` and
        ``dtype_source`` are accepted for the reference's signature: its
        parameters keep their dtype either way)."""
        from ..ndarray import load_tensors
        loaded = load_tensors(filename)
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if any(p._data is None for p in params.values()):
            # a parameter without data is made anew: graphs over the
            # tree would read stale addresses
            self._drop_graphs()
        if not any("." in k for k in loaded):
            # legacy ParameterDict-format file (full-prefix names)
            del loaded
            self.collect_params().load(
                filename, ctx, allow_missing, ignore_extra, self.prefix,
                cast_dtype=cast_dtype, dtype_source=dtype_source)
            return
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise AssertionError(
                        f"Parameter '{name}' is missing in file "
                        f"'{filename}', which contains parameters: "
                        f"{_brief_print_list(loaded.keys())}")
        for name, value in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise ValueError(
                        f"Parameter '{name}' loaded from file '{filename}' "
                        "is not present in this block")
                continue
            params[name]._load(value, ctx)

    def _collect_params_with_prefix(self, prefix=""):
        """``{structural path: Parameter}``: attribute names of the
        parameters, child names (attribute names, or indices of
        ``add``) joined by dots."""
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._modules.items():
            if child is not None:
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def _serving_device(self):
        """The device of the tree's parameters: of the first with data,
        else the one its deferred initialization names; the CPU for a
        block without parameters."""
        for p in self.collect_params().values():
            if p._data is not None:
                return p._data.device
            if p._deferred_init:
                return p._deferred_init[1]
        return torch.device("cpu")

    def serve(self, example_input=None, **server_kwargs):
        """Serve this block's forward directly through a
        :class:`mxnet_tpu_torch.serving.ModelServer`: dynamic
        micro-batching of concurrent requests, bucket padding, and on
        the card one CUDA graph per bucket, captured by ``warmup()``.

        ``example_input`` (a single sample, NO batch dim; numpy or a
        tensor) resolves any deferred parameter shapes and pins the
        server's item shape/dtype so ``warmup()`` works before the first
        request. Returns an **unstarted** server — call ``start()`` (or
        use it as a context manager)::

            with net.serve(example_input=x0, max_batch_size=16) as srv:
                srv.warmup()
                fut = srv.submit(x0)
        """
        from .. import autograd
        from ..serving import ModelServer
        if example_input is not None:
            ex = (example_input.detach().cpu().numpy()
                  if isinstance(example_input, torch.Tensor)
                  else np.asarray(example_input))
            with autograd.pause(train_mode=False):
                # resolve deferred shapes
                self(torch.from_numpy(ex[None]).to(self._serving_device()))
            server_kwargs.setdefault("item_shape", ex.shape)
            server_kwargs.setdefault("dtype", ex.dtype)
        return ModelServer(self, **server_kwargs)

    def hybridize(self, active=True, **kwargs):
        """Hybridize (or, ``active=False``, un-hybridize) every
        :class:`HybridBlock` of the tree: on the card a hybridized
        block's call replays a CUDA graph per input signature
        (:class:`CachedOp`); a plain ``Block`` only passes the flag to
        its children, as in the reference."""
        for child in self._children_blocks():
            child.hybridize(active, **kwargs)

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def summary(self, *inputs):
        """Print a table of every block's output shape and parameter
        count over one forward of ``inputs`` (the reference's rows:
        ``Input``, then ``<Class>-<n>`` in the order forwards finish)."""
        summary = OrderedDict()
        hooks = []

        def shape_str(args):
            flat = []

            def walk(a):
                if isinstance(a, (list, tuple)):
                    for v in a:
                        walk(v)
                else:
                    flat.append(a)
            walk(args)
            shapes = [tuple(x.shape) for x in flat
                      if isinstance(x, (torch.Tensor, NDArray))]
            return str(shapes[0] if len(shapes) == 1 else shapes)

        def register(block):
            def hook(block, _, outputs):
                key = f"{block.__class__.__name__}-{len(summary)}"
                row = summary[key] = OrderedDict()
                row["output_shape"] = shape_str(outputs)
                row["n_params"] = row["trainable"] = row["shared"] = 0
                for p in block.params.values():
                    if p._data is None:
                        continue
                    row["n_params"] += p.data().numel()
                    if p.grad_req != "null":
                        row["trainable"] += p.data().numel()
            hooks.append(block.register_forward_hook(hook))

        summary["Input"] = OrderedDict(output_shape=shape_str(inputs),
                                       n_params=0, trainable=0, shared=0)
        try:
            self.apply(register)
            self(*inputs)
            line = "{:>20}  {:>42} {:>15}"
            print("-" * 80)
            print(line.format("Layer (type)", "Output Shape", "Param #"))
            print("=" * 80)
            total = trainable = 0
            for layer, row in summary.items():
                print(line.format(layer, str(row["output_shape"]),
                                  row["n_params"]))
                total += row["n_params"]
                trainable += row["trainable"]
            print("=" * 80)
            print(f"Total params: {total}")
            print(f"Trainable params: {trainable}")
            print("-" * 80)
        finally:
            for h in hooks:
                h.detach()


class _HookHandle:
    """Handle of a gluon forward (pre-)hook: ``detach()`` removes it."""

    _next_id = 0

    def __init__(self, hooks_dict, hook):
        self._hooks_dict = hooks_dict
        self._id = _HookHandle._next_id
        _HookHandle._next_id += 1
        hooks_dict[self._id] = hook

    def detach(self):
        self._hooks_dict.pop(self._id, None)


def _indent(s, num_spaces):
    lines = s.split("\n")
    first = lines.pop(0)
    return first + "".join("\n" + " " * num_spaces + line for line in lines)


def _brief_print_list(lst, limit=7):
    lst = list(lst)
    if len(lst) > limit:
        return _brief_print_list(lst[:limit // 2], limit) + ", ..., " + \
            _brief_print_list(lst[-limit // 2:], limit)
    return ", ".join(f"'{s}'" for s in lst)


def _flatten(obj):
    """(leaves, structure) of nested lists and tuples: tensors are
    ``"T"`` leaves, NDArrays ``"N"`` leaves (their tensors), anything
    else (a dict too, as in the reference) an opaque ``"O"`` leaf."""
    leaves = []

    def walk(o):
        if isinstance(o, NDArray):
            leaves.append(o._data)
            return "N"
        if isinstance(o, torch.Tensor):
            leaves.append(o)
            return "T"
        if isinstance(o, (list, tuple)):
            return ("L" if isinstance(o, list) else "U",
                    tuple(walk(v) for v in o))
        leaves.append(o)
        return "O"
    return leaves, walk(obj)


def _regroup(leaves, fmt):
    """Rebuild :func:`_flatten`'s structure from its leaves (an ``"N"``
    leaf as an NDArray over it)."""
    it = iter(leaves)

    def build(f):
        if f == "N":
            return NDArray(next(it))
        if isinstance(f, str):
            return next(it)
        kids = [build(c) for c in f[1]]
        return kids if f[0] == "L" else tuple(kids)
    return build(fmt)


class _SuspendTLS(threading.local):
    def __init__(self):
        self.blocks = set()


_suspend_tls = _SuspendTLS()


class _suspend_hybridization:
    """Run a block's forward through the eager path instead of its
    CachedOp, for the block and every descendant, on this thread only
    (a per-thread set of block ids, not a flip of the shared flag: other
    threads calling the same net keep replaying its graphs; reference:
    ``src/imperative/cached_op_threadsafe.h``)."""

    def __init__(self, block):
        self._block = block
        self._added = []

    def __enter__(self):
        suspended = _suspend_tls.blocks

        def _save(b):
            if isinstance(b, HybridBlock) and id(b) not in suspended:
                suspended.add(id(b))
                self._added.append(id(b))
        self._block.apply(_save)

    def __exit__(self, *exc):
        _suspend_tls.blocks.difference_update(self._added)


class _Graphs:
    """One signature's CUDA graphs: the forward (and, for a call under
    ``autograd.record()``, the backward, captured as a pair in one
    pool), its static inputs and outputs, and the lock that serializes
    its replays."""

    __slots__ = ("static_in", "out_fmt", "outs", "tensor_idx", "fwd",
                 "bwd", "gouts", "grads", "grad_of", "diff_idx", "lock",
                 "layout", "gen", "generation")

    def __init__(self):
        self.lock = threading.Lock()
        self.bwd = None
        self.generation = 0


class _Replay(torch.autograd.Function):
    """A recorded call of a captured pair: the forward graph's replay,
    then, at backward, the backward graph's. Inputs: the graphs, the
    call's tensors, then the parameters that take gradients."""

    @staticmethod
    def forward(ctx, g, *tensors):
        with g.lock:
            for s, t in zip(g.static_in, tensors[:len(g.static_in)]):
                s.copy_(t)
            g.fwd.replay()
            g.generation += 1
            ctx.g, ctx.generation = g, g.generation
            outs = tuple(g.outs[i].clone() for i in g.tensor_idx)
        ctx.mark_non_differentiable(*[
            o for k, o in zip(g.tensor_idx, outs) if k not in g.diff_idx])
        return outs

    @staticmethod
    def backward(ctx, *gouts):
        g = ctx.g
        with g.lock:
            if g.generation != ctx.generation:
                raise RuntimeError(
                    "a hybridized block's forward graph was replayed again "
                    "before the backward of an earlier call: run backward "
                    "before the next recorded call, or hybridize(active="
                    "False) for this use")
            for s, i in zip(g.gouts, g.diff_idx):
                go = gouts[g.tensor_idx.index(i)]
                if go is None:
                    s.zero_()
                else:
                    s.copy_(go)
            g.bwd.replay()
            grads = [None if j is None else g.grads[j].clone()
                     for j in g.grad_of]
        return (None,) + tuple(grads)


class CachedOp:
    """A hybridized block's call (mirrors the reference's ``CachedOp``,
    ``mxnet_tpu/gluon/block.py``): one CUDA graph per signature on the
    card, the eager forward on the CPU.

    A signature is the reference's key, ``(training, input structure,
    opaque arguments)``, plus whether the call records for autograd, the
    AMP state, and each input tensor's shape, dtype, device and
    ``requires_grad``. Non-array arguments must be hashable (a
    ``TypeError`` otherwise). ``signatures`` counts the signatures seen.

    On the card the first call of a signature resolves deferred shapes
    (one eager pass in predict mode), makes a warm run on a side stream
    (it builds every kernel; its writes to parameters, such as running
    statistics, are undone), captures the graph(s) through
    :func:`~mxnet_tpu_torch.kernels.capture` and replays; later calls
    copy their tensors into the graph's static inputs, replay under the
    signature's lock and return copies of its outputs. Under
    ``autograd.record()`` the forward and the backward are captured as a
    pair (``torch.autograd.grad`` over the inputs that require gradients
    and the block's parameters), replayed by an autograd function: its
    backward must run before the signature's next recorded call. The
    parameters are read by address: an in-place change (``set_data``,
    a BatchNorm's running statistics) is seen by the next replay, and a
    parameter that moves drops the graphs (a changed address is checked
    at every call). Draws through :mod:`~mxnet_tpu_torch._rng` inside
    the block take one generator registered with the graph; the call
    advances the draw position once.

    The graphs are bypassed (the eager forward runs) inside another
    capture, inside a compiled training step, under
    ``gluon.parameter.param_values`` (the graphs read the parameters'
    own tensors) and on the CPU."""

    def __init__(self, block, static_alloc=False, static_shape=False):
        self._block = block
        self._entries = {}          # signature -> _Graphs, or None (CPU)
        self._trace_lock = threading.Lock()
        self._stream = None
        self._pool = None
        self._param_list = None

    @property
    def signatures(self):
        return len(self._entries)

    @property
    def graphs(self):
        """CUDA graphs held (a recorded signature's pair counts two)."""
        return sum(0 if g is None else 1 + (g.bwd is not None)
                   for g in self._entries.values())

    def _params(self):
        # snapshot once, as the reference's CachedOp; hybridize() and
        # cast() make a new CachedOp
        if self._param_list is None:
            self._param_list = list(self._block.collect_params().values())
        return self._param_list

    def _eager(self, args, kwargs):
        with _suspend_hybridization(self._block):
            return torch.nn.Module.__call__(self._block, *args, **kwargs)

    def __call__(self, *args, **kwargs):
        from .. import _rng, autograd, jit
        from ..ops import invoke as _invoke
        from .parameter import substituted
        leaves, fmt = _flatten((args, tuple(kwargs.values())))
        tensors = [v for v in leaves if isinstance(v, torch.Tensor)]
        opaque = tuple(v for v in leaves if not isinstance(v, torch.Tensor))
        fmt = (fmt, tuple(kwargs))
        training = autograd.is_training()
        recording = torch.is_grad_enabled() and (
            any(t.requires_grad for t in tensors) or any(
                p._data is not None and p._data.requires_grad
                for p in self._params()))
        amp = _invoke._AMP
        key = (training, recording, fmt, opaque,
               (amp["active"], amp["dtype"] if amp["active"] else None))
        try:
            hash(key)
        except TypeError:
            raise TypeError(
                "hybridized blocks require non-array arguments to be "
                f"hashable (got {opaque!r}); pass arrays or hashable "
                "constants, or skip hybridize() for this block") from None
        device = tensors[0].device if tensors else None
        if device is None or device.type != "cuda" or \
                jit.in_compiled_step() or substituted() or \
                torch.cuda.is_current_stream_capturing():
            if device is None or device.type != "cuda":
                self._resolve_deferred(args, kwargs)
                self._entries.setdefault(key + self._sig(tensors), None)
            return self._eager(args, kwargs)
        sig = key + self._sig(tensors)
        pos = _rng.reserve_draw()            # one draw position a call
        g = self._entries.get(sig)
        if g is not None and g.layout != self._layout():
            self._entries = {}               # a parameter moved
            g = None
        if g is None:
            with self._trace_lock:
                g = self._entries.get(sig)
                if g is None:
                    self._resolve_deferred(args, kwargs)
                    g = self._capture(args, kwargs, tensors, recording,
                                      pos)
                    self._entries[sig] = g
        if recording:
            params = [p._data for p in self._params()
                      if p._data is not None and p._data.requires_grad]
            outs = _Replay.apply(g, *tensors, *params)
        else:
            with g.lock:
                for s, t in zip(g.static_in, tensors):
                    s.copy_(t)
                g.fwd.replay()
                outs = tuple(g.outs[i].clone() for i in g.tensor_idx)
        flat = list(g.outs)
        for i, o in zip(g.tensor_idx, outs):
            flat[i] = o
        return _regroup(flat, g.out_fmt)

    @staticmethod
    def _sig(tensors):
        return tuple((tuple(t.shape), t.dtype, t.device, t.requires_grad)
                     for t in tensors)

    def _layout(self):
        return tuple(p._data.data_ptr() if p._data is not None else 0
                     for p in self._params())

    def _resolve_deferred(self, args, kwargs):
        """Deferred shapes resolve through one eager pass in predict mode
        (no running-statistics writes), as the reference's warm-up."""
        from .. import autograd
        params = self._params()
        if any(p._data is None and (p.shape is None or 0 in p.shape)
               for p in params):
            with autograd.pause(train_mode=False):
                self._eager(args, kwargs)
        for p in params:
            p._finish_deferred_init()

    def _capture(self, args, kwargs, tensors, recording, pos):
        """Warm run, capture (a pair when ``recording``) and the static
        buffers of one signature; its generator is draw ``pos``'s."""
        from .. import _rng, autograd, kernels
        from .parameter import track_access
        block = self._block
        dev = tensors[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        g = _Graphs()
        g.static_in = [torch.empty_like(
            t, memory_format=torch.contiguous_format).copy_(t.detach())
            .requires_grad_(t.requires_grad) for t in tensors]
        g.gen = _rng.generator_for(_rng.get_state()["seed"], pos, dev)
        leaves, fmt = _flatten((args, tuple(kwargs.values())))
        names = tuple(kwargs)
        training = autograd.is_training()
        params = [p._data for p in self._params()
                  if p._data is not None and p._data.requires_grad]
        wrt = [s for s in g.static_in if s.requires_grad] + params

        def forward():
            it = iter(g.static_in)
            a, kwv = _regroup([next(it) if isinstance(v, torch.Tensor)
                               else v for v in leaves], fmt)
            kw = dict(zip(names, kwv))
            old = _rng.push_trace_generator(g.gen)
            try:
                with autograd._Scope(recording, training):
                    out = self._eager(a, kw)
            finally:
                _rng.pop_trace_generator(old)
            return _flatten(out)

        def backward(outs, gouts):
            diff = [outs[i] for i in g.diff_idx]
            got = torch.autograd.grad(diff, wrt, gouts, allow_unused=True)
            return list(got)

        def warm():
            outs, out_fmt = forward()
            if recording:
                diff = [i for i, o in enumerate(outs)
                        if isinstance(o, torch.Tensor) and o.requires_grad]
                if diff:
                    g.diff_idx = diff
                    backward(outs, [torch.ones_like(outs[i]) for i in diff])
        what = f"hybridized block {block.name!r}"
        with track_access() as access:
            kernels.warm(warm, self._stream, what)
        access.restore()                 # the warm run's writes
        held = {}

        def capture_fwd():
            held["outs"], held["fmt"] = forward()
        g.fwd = kernels.capture(capture_fwd, self._stream, self._pool,
                                what=what, warmed=True, generators=(g.gen,))
        outs, g.out_fmt = held["outs"], held["fmt"]
        g.tensor_idx = [i for i, o in enumerate(outs)
                        if isinstance(o, torch.Tensor)]
        g.diff_idx = [i for i in g.tensor_idx if outs[i].requires_grad] \
            if recording else []
        g.outs = outs
        if g.diff_idx:
            g.gouts = [torch.empty_like(outs[i]) for i in g.diff_idx]

            def capture_bwd():
                held["grads"] = backward(outs, g.gouts)
            g.bwd = kernels.capture(capture_bwd, self._stream,
                                    g.fwd.graph.pool(), what=what + "'s "
                                    "backward", warmed=True)
            g.grads = held["grads"]
            # the capture's autograd graph is done with: drop it, with the
            # side stream's gradient accumulators it holds
            g.outs = outs = [o.detach() if isinstance(o, torch.Tensor)
                             else o for o in outs]
            n_in = len(wrt) - len(params)
            pos = iter(range(len(wrt)))
            g.grad_of = [next(pos) if t.requires_grad else None
                         for t in g.static_in] + [n_in + j for j in
                                                  range(len(params))]
            g.grad_of = [j if j is not None and g.grads[j] is not None
                         else None for j in g.grad_of]
        g.layout = self._layout()
        return g


class HybridBlock(Block):
    """A Block written as ``hybrid_forward(F, x, *args, **params)``: ``F``
    is the port's operator namespace on tensors (:class:`_OpNamespace`)
    and ``params`` this block's parameter tensors by attribute name.
    Deferred shapes are inferred from the first input
    (``_infer_param_shapes``).

    ``hybridize()`` makes the block's calls go through a
    :class:`CachedOp`: one CUDA graph per input signature on the card
    (the reference's one XLA program per signature), the eager forward
    on the CPU. ``hybridize()`` again, ``cast``, ``reset_ctx``,
    ``initialize(force_reinit=True)`` and a ``load_parameters`` that
    makes parameters anew drop the graphs."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op = None
        self._cached_op_lock = threading.Lock()
        self._flags = {}

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        self._cached_op = None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def _get_cached_op(self):
        # double-checked: two threads' first calls must build one
        # CachedOp (one trace lock)
        if self._cached_op is None:
            with self._cached_op_lock:
                if self._cached_op is None:
                    self._cached_op = CachedOp(self, **{
                        k: v for k, v in self._flags.items()
                        if k in ("static_alloc", "static_shape")})
        return self._cached_op

    def _forward_call(self):
        if self._active and id(self) not in _suspend_tls.blocks:
            return self._get_cached_op()
        return super()._forward_call()

    def infer_shape(self, *args):
        """Infer deferred parameter shapes from inputs."""
        self._infer_param_shapes(*args)

    def _infer_param_shapes(self, *args):
        pass

    def forward(self, x, *args):
        try:
            params = {k: v.data() for k, v in self._reg_params.items()}
        except DeferredInitializationError:
            self._infer_param_shapes(x, *args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            params = {k: v.data() for k, v in self._reg_params.items()}
        return self.hybrid_forward(_F, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0, remove_amp_cast=True):
        """Write the parameters for deployment to ``path-NNNN.params``
        (reference: block.py:1241) through ``nd.save``: keyed by
        structural path, ``arg:`` for a parameter with a gradient,
        ``aux:`` for one without. No graph JSON is written, as the JAX
        package writes none. Returns the file name."""
        from ..ndarray import save as nd_save
        params = self._collect_params_with_prefix()
        arg_dict = {f"arg:{k}": v.data().detach()
                    for k, v in params.items() if v.grad_req != "null"}
        arg_dict.update({f"aux:{k}": v.data().detach()
                         for k, v in params.items() if v.grad_req == "null"})
        pfile = f"{path}-{epoch:04d}.params"
        nd_save(pfile, arg_dict)
        return pfile

    def optimize_for(self, x, *args, backend=None, **kwargs):
        """Hybridize and run once on ``x`` (reference: block.py
        optimize_for; there are no partitioning backends: the block's
        graphs are its CUDA graphs)."""
        self.hybridize(True)
        return self(x, *args)


class SymbolBlock(HybridBlock):
    """A block running a Symbol graph (reference: block.py:1403): the
    graph's arguments other than ``inputs`` are its parameters (its aux
    states with ``grad_req="null"``), named as the graph names them.
    Parameter shapes left unknown are inferred from the first input's
    shapes (``Symbol._solve_shapes``)."""

    def __init__(self, outputs, inputs, params=None):
        # empty prefix: symbol argument names ARE the parameter names
        super().__init__(prefix="", params=params)
        from ..symbol import Symbol
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1:
            outputs = outputs[0]
        if not isinstance(outputs, Symbol):
            raise TypeError("outputs must be a Symbol")
        self._outputs = outputs
        self._inputs = inputs if isinstance(inputs, (list, tuple)) \
            else [inputs]
        input_names = {i.name for i in self._inputs}
        for name in outputs.list_arguments():
            if name not in input_names:
                self.params.get(name, allow_deferred_init=True)
        for name in outputs.list_auxiliary_states():
            self.params.get(name, allow_deferred_init=True,
                            grad_req="null")

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock of a ``-symbol.json`` file, its parameters
        loaded from ``param_file`` (either package's)."""
        from ..symbol import load as sym_load
        from ..symbol import var as sym_var
        sym = sym_load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        inputs = [sym_var(n) for n in input_names]
        ret = SymbolBlock(sym, inputs)
        if param_file is not None:
            ret.load_parameters(param_file, ctx=ctx, cast_dtype=True,
                                dtype_source="saved")
        return ret

    def forward(self, x, *args):
        input_names = [i.name for i in self._inputs]
        xs = (x,) + args
        params = self.collect_params()
        if any(p._data is None for p in params.values()):
            # deferred shapes from the inputs' through the shape solver
            known = {n: tuple(v.shape) for n, v in zip(input_names, xs)}
            shape_of, _, _ = self._outputs._solve_shapes(known,
                                                         partial=True)
            for pname, p in params.items():
                if p._data is None and pname in shape_of:
                    p.shape = shape_of[pname]
                    p._finish_deferred_init()
        try:
            bindings = {n: p.data() for n, p in params.items()}
        except DeferredInitializationError:
            raise RuntimeError(
                "Parameters of SymbolBlock could not be shape-inferred "
                "from the inputs: load params or initialize() with "
                "explicit shapes first") from None
        bindings.update(zip(input_names, xs))
        names = self._outputs.list_inputs()
        out = self._outputs._build_fn(names)(*[bindings[n] for n in names])
        return list(out) if isinstance(out, tuple) else out

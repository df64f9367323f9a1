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
block of the same structure.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

import numpy as np
import torch

from ..ndarray.ndarray import NDArray, unwrap
from ..ops import nn as _nn
from .parameter import DeferredInitializationError, Parameter, \
    ParameterDict

__all__ = ["Block", "HybridBlock"]


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

    def __call__(self, *args, **kwargs):
        # NDArrays are unwrapped once, here: blocks compute on tensors
        args, kwargs = unwrap(args), unwrap(kwargs)
        if not (self._gluon_pre_hooks or self._gluon_hooks):
            return super().__call__(*args, **kwargs)
        # hooks see every input: keyword inputs appended as a dict
        hook_args = args + (kwargs,) if kwargs else args
        for hook in list(self._gluon_pre_hooks.values()):
            hook(self, hook_args)
        out = super().__call__(*args, **kwargs)
        for hook in list(self._gluon_hooks.values()):
            hook(self, hook_args, out)
        return out

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

    def initialize(self, init=None, device=None, generator=None):
        """Initialize every parameter of the tree on ``device`` (default:
        the card); ``init`` (default ``Uniform()``) serves parameters
        without their own initializer. Draws come from ``generator``."""
        self.collect_params().initialize(init, device, generator)

    def cast(self, dtype):
        """Cast every parameter of the tree to ``dtype`` (see
        :meth:`.Parameter.cast`)."""
        for child in self._children_blocks():
            child.cast(dtype)
        for param in self.params.values():
            param.cast(dtype)

    def zero_grad(self):
        """Set every gradient of the tree to zero, in place."""
        self.collect_params().zero_grad()

    def reset_ctx(self, ctx):
        """Move every parameter of the tree to device ``ctx``."""
        self.collect_params().reset_ctx(ctx)

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
        """Accepted for API parity; compiles nothing in this slice.

        Blocks run eagerly, one PyTorch call per operation. The JAX
        package traces a hybridized block into one XLA program; the
        port's counterpart (a CachedOp as a CUDA graph per input
        signature) is later work (ROADMAP.md §1 item 13b)."""

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


class HybridBlock(Block):
    """A Block written as ``hybrid_forward(F, x, *args, **params)``: ``F``
    is the port's operator namespace on tensors (:class:`_OpNamespace`)
    and ``params`` this block's parameter tensors by attribute name.
    Deferred shapes are inferred from the first input
    (``_infer_param_shapes``)."""

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

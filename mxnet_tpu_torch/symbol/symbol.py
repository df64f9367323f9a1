"""Symbol: the legacy lazy-graph API of the port (mirrors
``mxnet_tpu/symbol/symbol.py``; reference: python/mxnet/symbol/symbol.py).

A Symbol is a Python DAG node over the port's op registry
(:mod:`mxnet_tpu_torch.ops.registry`), with the JAX package's slots and
naming, so ``list_arguments``, ``list_auxiliary_states`` and
``list_outputs`` give its names letter for letter, and the same JSON
(``"mxnet_tpu_version": 1``): a graph saved by one package loads in the
other.

Evaluating a graph (:meth:`Symbol._build_fn`) walks the DAG and calls
each op's impl on tensors, so an op with a hand-written kernel (the
attention op's flash kernels) launches it on a CUDA tensor. A random op
draws from the port's own generators (:func:`mxnet_tpu_torch._rng.
next_generator` on its input's device), not the JAX package's keys.
Shape and type inference run each op's impl on ``torch.device("meta")``
tensors (shapes and dtypes only, no data); an op that cannot run there
has a rule in :data:`_SHAPE_RULES`.
"""
from __future__ import annotations

import json
from typing import Dict, List

import numpy as _np
import torch

from ..base import MXNetError, torch_dtype
from ..ops.registry import get as get_op
from .. import _rng

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "zeros", "ones", "arange"]

# aux-state parameter name suffixes (reference: BatchNorm aux states are
# moving_mean/moving_var; executors separate arg vs aux arrays)
_AUX_SUFFIXES = ("_moving_mean", "_moving_var", "_running_mean",
                 "_running_var")


class Symbol:
    """A node in the symbolic graph."""

    __slots__ = ("_op", "_params", "_inputs", "_name", "_attr", "_nout",
                 "_out_index", "_shape_hint", "_dtype_hint")

    def __init__(self, op, params, inputs, name, nout=1, out_index=None,
                 attr=None):
        self._op = op              # op name string, or None for variables
        self._params = params or {}
        self._inputs = list(inputs)
        self._name = name
        self._nout = nout
        self._out_index = out_index  # select one output of a multi-out op
        self._attr = dict(attr or {})
        self._shape_hint = None
        self._dtype_hint = None

    # ------------------------------------------------------------- intro --
    @property
    def name(self):
        return self._name

    def attr(self, key):
        return self._attr.get(key)

    def list_attr(self):
        return dict(self._attr)

    def attr_dict(self):
        """Attributes of every node in the graph keyed by node name,
        omitting attr-less nodes (reference: symbol.py attr_dict)."""
        out = {}
        for s in self._topo():
            if s._attr:
                out[s._name] = dict(s._attr)
        return out

    def _is_var(self):
        return self._op is None and self._out_index is None

    def _is_group(self):
        return self._op == "_group"

    def _topo(self):
        """Post-order DAG traversal (deduped)."""
        seen = {}
        order = []

        def visit(s):
            if id(s) in seen:
                return
            seen[id(s)] = s
            for i in s._inputs:
                visit(i)
            order.append(s)
        visit(self)
        return order

    def list_arguments(self) -> List[str]:
        """All variable names, in graph order, excluding aux states
        (reference: symbol.py list_arguments)."""
        return [s._name for s in self._topo()
                if s._is_var() and not s._name.endswith(_AUX_SUFFIXES)]

    def list_auxiliary_states(self) -> List[str]:
        return [s._name for s in self._topo()
                if s._is_var() and s._name.endswith(_AUX_SUFFIXES)]

    def list_inputs(self):
        return [s._name for s in self._topo() if s._is_var()]

    def list_outputs(self) -> List[str]:
        if self._is_group():
            out = []
            for i in self._inputs:
                out.extend(i.list_outputs())
            return out
        base = self._name
        if self._nout == 1 or self._out_index is not None:
            return [base + "_output"]
        return [f"{base}_output{i}" for i in range(self._nout)]

    @property
    def num_outputs(self):
        if self._is_group():
            return sum(i.num_outputs for i in self._inputs)
        return 1 if self._out_index is not None else self._nout

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            index = names.index(index)
        if self._is_group():
            return self._inputs[index]
        if self._nout == 1:
            if index != 0:
                raise IndexError(f"index {index} out of range")
            return self
        return Symbol(self._op, self._params, self._inputs,
                      self._name, nout=self._nout, out_index=index,
                      attr=self._attr)

    def __iter__(self):
        return (self[i] for i in range(self.num_outputs))

    def __len__(self):
        return self.num_outputs

    def get_internals(self):
        """Group of every node's outputs (reference: symbol.py
        get_internals) — used to cut feature extractors."""
        nodes = [s for s in self._topo() if not s._is_group()]
        return Group(nodes)

    def get_children(self):
        return Group(self._inputs) if self._inputs else None

    def __repr__(self):
        if self._is_var():
            return f"<Symbol variable {self._name}>"
        return f"<Symbol {self._name}>"

    # ------------------------------------------------------- composition --
    def __call__(self, *args, **kwargs):
        """Compose: substitute this graph's free variables with other
        symbols (reference: symbol.py __call__/_compose)."""
        s = self._deepcopy({})
        s._compose(*args, **kwargs)
        return s

    def _deepcopy(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        cp = Symbol(self._op, dict(self._params),
                    [i._deepcopy(memo) for i in self._inputs],
                    self._name, nout=self._nout,
                    out_index=self._out_index, attr=self._attr)
        cp._shape_hint = self._shape_hint
        cp._dtype_hint = self._dtype_hint
        memo[id(self)] = cp
        return cp

    def _compose(self, *args, **kwargs):
        if args and kwargs:
            raise TypeError(
                "compose accepts positional or keyword, not both")
        variables = [s for s in self._topo() if s._is_var()]
        if args:
            if len(args) > len(variables):
                raise ValueError("too many positional arguments")
            mapping = dict(zip([v._name for v in variables], args))
        else:
            mapping = kwargs
        for node in self._topo():
            node._inputs = [
                mapping.get(i._name, i) if i._is_var() else i
                for i in node._inputs]

    # ---------------------------------------------------------- evaluate --
    def _build_fn(self, input_names: List[str], collect_aux=False,
                  is_train=None, abstract=False):
        """The DAG as ``fn(*tensors)``, its arguments in ``input_names``
        order.

        collect_aux: also return ``{aux_var_name: new_value}``, the
        BatchNorm running-statistic updates (the momentum blend of the
        running and the batch statistics, as the JAX package computes
        it), for the caller to write into the aux arrays.
        abstract: ``fn`` takes meta tensors and runs each op through
        :func:`_abstract_call` (shapes and dtypes only)."""
        order = self._topo()

        def fn(*arrays):
            env = dict(zip(input_names, arrays))
            if is_train is None:
                from .. import autograd
                training = autograd.is_training()
            else:
                training = is_train
            device = next((a.device for a in arrays
                           if isinstance(a, torch.Tensor)), None)
            aux_updates = {}
            vals: Dict[int, object] = {}
            for node in order:
                if node._is_var():
                    if node._name not in env:
                        raise MXNetError(
                            f"unbound symbol variable {node._name!r}")
                    vals[id(node)] = env[node._name]
                elif node._is_group():
                    outs = []
                    for i in node._inputs:
                        v = vals[id(i)]
                        outs.extend(v if isinstance(v, tuple) else [v])
                    vals[id(node)] = tuple(outs)
                elif abstract:
                    out = _abstract_call(node, _node_inputs(node, vals))
                    vals[id(node)] = tuple(out) if isinstance(
                        out, (list, tuple)) else out
                else:
                    op = get_op(node._op)
                    ins = _node_inputs(node, vals)
                    params = dict(node._params)
                    if op.needs_rng and "rng" not in params:
                        dev = next((x.device for x in ins
                                    if isinstance(x, torch.Tensor)),
                                   device)
                        params["rng"] = _rng.next_generator(
                            dev if dev is not None else "cpu")
                    if op.needs_train and "_training" not in params:
                        params["_training"] = training
                    if collect_aux and node._op in ("BatchNorm",
                                                    "batch_norm") and \
                            training and not params.get(
                                "use_global_stats", False):
                        params["output_mean_var"] = True
                        out, bmean, bvar = op.impl(*ins, **params)
                        mom = params.get("momentum", 0.9)
                        with torch.no_grad():
                            aux_updates[node._inputs[3]._name] = \
                                ins[3] * mom + bmean * (1 - mom)
                            aux_updates[node._inputs[4]._name] = \
                                ins[4] * mom + bvar * (1 - mom)
                        vals[id(node)] = out
                        continue
                    out = _call(op, ins, params)
                    vals[id(node)] = tuple(out) if isinstance(
                        out, (list, tuple)) else out
            root = vals[id(self)]
            if self._out_index is not None and isinstance(root, tuple):
                root = root[self._out_index]
            if collect_aux:
                return root, aux_updates
            return root

        return fn

    def eval_dict(self, bindings):
        """Evaluate with ``{name: NDArray}`` bindings; returns an NDArray
        or a list (reference: symbol.py eval). Numpy bindings go to the
        device of the first NDArray or tensor binding, else the card."""
        from ..ndarray import NDArray
        from .._device import resolve_device
        names = self.list_inputs()
        missing = [n for n in names if n not in bindings]
        if missing:
            raise MXNetError(f"missing binding for {missing[0]}")
        vals = [bindings[n] for n in names]
        dev = next((v._data.device if isinstance(v, NDArray) else v.device
                    for v in vals if isinstance(v, (NDArray, torch.Tensor))),
                   None)
        if dev is None:
            dev = resolve_device()
        arrays = [v._data if isinstance(v, NDArray) else
                  v if isinstance(v, torch.Tensor) else
                  torch.as_tensor(_np.asarray(v, _np.float32)).to(dev)
                  for v in vals]
        with torch.no_grad():
            out = self._build_fn(names)(*arrays)
        if isinstance(out, tuple):
            return [NDArray(o) for o in out]
        return NDArray(out)

    def eval(self, ctx=None, **kwargs):
        out = self.eval_dict(kwargs)
        return out if isinstance(out, list) else [out]

    # ------------------------------------------------------------- infer --
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes), each op run on meta
        tensors (reference: symbol.py infer_shape); ``(None, None,
        None)`` when the shapes cannot be inferred."""
        try:
            return self._infer_shape_impl(False, *args, **kwargs)
        except Exception:
            return None, None, None

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        names = self.list_inputs()
        known = {k: tuple(v) for k, v in kwargs.items() if v is not None}
        if args:
            known.update({k: tuple(v) for k, v in
                          zip(self.list_arguments(), args)
                          if v is not None})
        for n in names:
            if n not in known:
                hint = self._find_var(n)._shape_hint
                if hint:
                    known[n] = tuple(hint)
        shape_of, out_shapes, _ = self._solve_shapes(known, partial)
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        if not partial:
            missing = [n for n in names if n not in shape_of]
            if missing:
                raise MXNetError(f"unknown shape for inputs {missing}")
        return ([shape_of.get(n) for n in arg_names],
                out_shapes,
                [shape_of.get(n) for n in aux_names])

    def _solve_shapes(self, known, partial=False):
        """Topo-order shape propagation with parameter-shape deduction
        (the reference's bidirectional infer pass,
        src/executor/infer_graph_attr_pass.cc: weight shapes are deduced
        from data shapes + op attrs). Each op runs on f32 meta
        tensors."""
        shape_of = dict(known)
        node_out: Dict[int, object] = {}
        for node in self._topo():
            if node._is_var():
                if node._name in shape_of:
                    node_out[id(node)] = shape_of[node._name]
                continue
            if node._is_group():
                outs = []
                ok = True
                for i in node._inputs:
                    s = node_out.get(id(i))
                    if s is None:
                        ok = False
                        break
                    outs.extend(s if isinstance(s, list) else [s])
                if ok:
                    node_out[id(node)] = outs
                continue
            # deduce unknown parameter-variable inputs from data shape
            _deduce_param_shapes(node, node_out, shape_of)
            ins = []
            ok = True
            for i in node._inputs:
                s = node_out.get(id(i))
                if s is None and i._is_var():
                    s = shape_of.get(i._name)
                if s is None:
                    ok = False
                    break
                if isinstance(s, list):
                    s = s[i._out_index or 0]
                ins.append(tuple(s))
            if not ok:
                if partial:
                    continue
                raise MXNetError(
                    f"shape inference stuck at node {node._name!r} "
                    f"(op {node._op})")
            specs = [torch.empty(s, dtype=torch.float32, device="meta")
                     for s in ins]
            out = _abstract_call(node, specs)
            if isinstance(out, (tuple, list)):
                node_out[id(node)] = [tuple(o.shape) for o in out]
            else:
                node_out[id(node)] = tuple(out.shape)
        root = node_out.get(id(self))
        if root is None:
            out_shapes = None
        elif isinstance(root, list):
            if self._out_index is not None:
                out_shapes = [root[self._out_index]]
            else:
                out_shapes = list(root)
        else:
            out_shapes = [root]
        return shape_of, out_shapes, node_out

    def infer_type(self, *args, **kwargs):
        """(arg_types, out_types, aux_types) as numpy dtypes (bfloat16 as
        ``torch.bfloat16``), the graph run on meta tensors of the
        variables' shape hints (else ``(1,)``); ``(None, None, None)``
        when it cannot run."""
        from ..ndarray.ndarray import numpy_dtype
        names = self.list_inputs()
        arg_names = self.list_arguments()
        known = dict(kwargs)
        if args:
            known.update(dict(zip(arg_names, args)))
        dummy = []
        for n in names:
            hint = self._find_var(n)._shape_hint or (1,)
            dt = known.get(n, self._find_var(n)._dtype_hint or "float32")
            dummy.append(torch.empty(tuple(hint), dtype=torch_dtype(dt),
                                     device="meta"))
        try:
            with torch.no_grad():
                out = self._build_fn(names, abstract=True)(*dummy)
        except Exception:
            return None, None, None
        outs = out if isinstance(out, tuple) else (out,)
        aux_names = self.list_auxiliary_states()
        dt_of = dict(zip(names, [d.dtype for d in dummy]))
        return ([numpy_dtype(dt_of[n]) for n in arg_names],
                [numpy_dtype(o.dtype) for o in outs],
                [numpy_dtype(dt_of[n]) for n in aux_names])

    def _find_var(self, name):
        for s in self._topo():
            if s._is_var() and s._name == name:
                return s
        raise KeyError(name)

    # -------------------------------------------------------------- bind --
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        """Allocate f32 zero arrays of the inferred shapes on ``ctx``
        (default: ``current_context()``, the card) and bind
        (reference: symbol.py simple_bind → GraphExecutor::Init)."""
        from ..executor import Executor
        from ..ndarray import NDArray
        from .._device import resolve_device
        arg_shapes, _, aux_shapes = self._infer_shape_impl(False, **kwargs)
        if arg_shapes is None:
            raise MXNetError("cannot infer shapes for simple_bind")
        dev = resolve_device(ctx)
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()

        def zeros(s):
            return NDArray(torch.zeros(s, dtype=torch.float32, device=dev))
        args = {n: zeros(s) for n, s in zip(arg_names, arg_shapes)}
        args_grad = None
        if grad_req != "null":
            args_grad = {n: zeros(s) for n, s in zip(arg_names, arg_shapes)}
        aux = {n: zeros(s) for n, s in zip(aux_names, aux_shapes)}
        return Executor(self, ctx, args, args_grad, grad_req, aux)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """Bind with explicit arrays (reference: symbol.py bind)."""
        from ..executor import Executor
        arg_names = self.list_arguments()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        aux_names = self.list_auxiliary_states()
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(aux_names, aux_states))
        return Executor(self, ctx, args or {}, args_grad, grad_req,
                        aux_states or {})

    # ------------------------------------------------------------ grad ----
    def gradient(self, wrt):
        raise NotImplementedError(
            "symbol.gradient: use Executor.backward (autograd underneath)")

    # ----------------------------------------------------------- save/load -
    def tojson(self):
        """Serialize the DAG to JSON (reference format has nodes/heads;
        this carries the same structure so graphs round-trip)."""
        order = self._topo()
        idx = {id(s): i for i, s in enumerate(order)}
        nodes = []
        for s in order:
            # op nodes carry their op params; variable nodes carry
            # their attrs (e.g. the ``__init__`` initializer record) —
            # the same "attrs" slot the reference format uses for both
            src = s._params if s._op is not None else s._attr
            nodes.append({
                "op": s._op or "null",
                "name": s._name,
                "attrs": {k: json.dumps(v) for k, v in src.items()},
                "inputs": [[idx[id(i)], i._out_index or 0, 0]
                           for i in s._inputs],
                "nout": s._nout,
            })
        return json.dumps({"nodes": nodes,
                           "heads": [[idx[id(self)],
                                      self._out_index or 0, 0]],
                           "mxnet_tpu_version": 1}, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # ------------------------------------------------------- operators ----
    def _binop(self, other, opname, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            ins = [other, self] if reverse else [self, other]
            return _make_node(opname, ins, {})
        params = {"scalar": float(other)}
        return _make_node(scalar_op, [self], params)

    def __add__(self, o):
        return self._binop(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binop(o, "broadcast_sub", "_rminus_scalar",
                           reverse=True) if isinstance(o, Symbol) else \
            _make_node("_rminus_scalar", [self], {"scalar": float(o)})

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        if isinstance(o, Symbol):
            return self._binop(o, "broadcast_div", "_rdiv_scalar",
                               reverse=True)
        return _make_node("_rdiv_scalar", [self], {"scalar": float(o)})

    def __pow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar")

    def __neg__(self):
        return _make_node("negative", [self], {})

    # method mirrors used by legacy model code
    def reshape(self, shape):
        return _make_node("reshape", [self], {"shape": tuple(shape)})

    def transpose(self, *axes):
        return _make_node("transpose", [self],
                          {"axes": axes or None})

    def sum(self, axis=None, keepdims=False):
        return _make_node("sum", [self], {"axis": axis,
                                          "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return _make_node("mean", [self], {"axis": axis,
                                           "keepdims": keepdims})


def _deduce_param_shapes(node, node_out, shape_of):
    """Fill unknown parameter-variable shapes of one node from its data
    input's shape (reference: each op's shape function, e.g.
    src/operator/nn/fully_connected.cc FullyConnectedShape)."""
    ins = node._inputs
    if not ins or not ins[0]._is_var() and id(ins[0]) not in node_out:
        pass
    data_shape = None
    if ins:
        d = ins[0]
        data_shape = node_out.get(id(d)) or (
            shape_of.get(d._name) if d._is_var() else None)
        if isinstance(data_shape, list):
            data_shape = data_shape[d._out_index or 0]
    if data_shape is None:
        return
    p = node._params

    def put(i, shape):
        if i < len(ins) and ins[i]._is_var() and \
                ins[i]._name not in shape_of:
            shape_of[ins[i]._name] = tuple(shape)
            node_out[id(ins[i])] = tuple(shape)

    op = node._op
    import functools
    import operator as _op_mod
    if op == "FullyConnected":
        nh = p.get("num_hidden", 0)
        if p.get("flatten", True):
            in_units = functools.reduce(_op_mod.mul, data_shape[1:], 1)
        else:
            in_units = data_shape[-1]
        put(1, (nh, in_units))
        put(2, (nh,))
    elif op in ("Convolution", "Deconvolution"):
        kernel = tuple(p.get("kernel") or ())
        nf = p.get("num_filter", 0)
        ng = p.get("num_group", 1)
        c = data_shape[1]
        if op == "Convolution":
            put(1, (nf, c // ng) + kernel)
        else:
            put(1, (c, nf // ng) + kernel)
        put(2, (nf,))
    elif op in ("BatchNorm", "batch_norm"):
        c = data_shape[p.get("axis", 1)]
        for i in range(1, 5):
            put(i, (c,))
    elif op in ("LayerNorm", "layer_norm"):
        c = data_shape[p.get("axis", -1)]
        put(1, (c,))
        put(2, (c,))
    elif op in ("InstanceNorm", "GroupNorm"):
        c = data_shape[1]
        put(1, (c,))
        put(2, (c,))
    elif op == "Embedding":
        put(1, (p.get("input_dim", 0), p.get("output_dim", 0)))
    elif op in ("SoftmaxOutput", "softmax_cross_entropy"):
        put(1, data_shape[:-1])
    elif op in ("LinearRegressionOutput", "LogisticRegressionOutput",
                "MAERegressionOutput"):
        put(1, data_shape)
    elif op == "LeakyReLU" and p.get("act_type") == "prelu":
        put(1, (data_shape[1],))
    elif op == "RNN":
        # reference: src/operator/rnn.cc RNNShape — parameters is the
        # flat CuDNN-layout vector, states are (L*D, N, H); data is TNC
        from ..ops.rnn import rnn_param_size
        h = p.get("state_size", 0)
        nl = p.get("num_layers", 1)
        bi = bool(p.get("bidirectional", False))
        mode = p.get("mode", "lstm")
        put(1, (rnn_param_size(data_shape[-1], h, nl, mode, bi),))
        state_shape = (nl * (2 if bi else 1), data_shape[1], h)
        put(2, state_shape)
        put(3, state_shape)


def _node_inputs(node, vals):
    """The values of ``node``'s inputs: one output of a multi-output
    input where the edge selects it, else its first."""
    ins = []
    for i in node._inputs:
        v = vals[id(i)]
        if i._out_index is not None and isinstance(v, tuple):
            v = v[i._out_index]
        elif isinstance(v, tuple) and not i._is_group():
            v = v[0]
        ins.append(v)
    return ins


def _call(op, ins, params):
    """One op's impl on tensors; a non-differentiable op runs untaped,
    as :func:`mxnet_tpu_torch.ops.invoke.apply_op` runs it."""
    if op.variadic:
        def run():
            return op.impl(list(ins), **params)
    else:
        def run():
            return op.impl(*ins, **params)
    if op.differentiable:
        return run()
    with torch.no_grad():
        return run()


def _meta(shape, dtype=torch.float32):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _same_shape(ins, p):
    return torch.empty_like(ins[0])


def _softmax_shape(ins, p):
    dtype = p.get("dtype")
    return _meta(ins[0].shape, torch_dtype(dtype) if dtype
                 else ins[0].dtype)


def _ctc_shape(ins, p):
    # data (T, N, C): one loss a sequence
    return _meta((ins[0].shape[1],), ins[0].dtype)


def _wq_matmul_shape(ins, p):
    # x (..., K) times qw (K, N): f32 (..., N)
    return _meta(tuple(ins[0].shape[:-1]) + (ins[1].shape[-1],))


# Ops whose impl cannot run on meta tensors (a kernel wrapper, a read of
# the data on the host, an aten op without a meta kernel): their output
# shapes and dtypes from the input shapes and the node's params.
_SHAPE_RULES = {
    "scaled_dot_product_attention": _same_shape,
    "softmax": _softmax_shape,
    "CTCLoss": _ctc_shape,
    "ctc_loss": _ctc_shape,
    "_histogram": lambda ins, p: _meta((int(p.get("bin_cnt", 10)),)),
    "_contrib_allclose": lambda ins, p: _meta((1,)),
    "_npx_constraint_check": lambda ins, p: _meta((), torch.bool),
    "quantized_matmul": _wq_matmul_shape,
    "_contrib_quantized_matmul": _wq_matmul_shape,
}


def _abstract_call(node, ins):
    """``node``'s op on meta tensors ``ins``: its impl, with the
    training flag off and no generator, else its shape rule."""
    op = get_op(node._op)
    rule = _SHAPE_RULES.get(node._op)
    if rule is not None:
        return rule(ins, node._params)
    params = dict(node._params)
    if op.needs_rng:
        params["rng"] = None
    if op.needs_train:
        params["_training"] = False
    with torch.no_grad():
        return _call(op, ins, params)


_NAME_COUNTER: Dict[str, int] = {}


def _auto_name(hint):
    n = _NAME_COUNTER.get(hint, 0)
    _NAME_COUNTER[hint] = n + 1
    return f"{hint}{n}"


def _make_node(opname, inputs, params, name=None, nout=1):
    op = get_op(opname)
    n = op.nout
    if n == -1:
        # dynamic-output ops: the count is decided by static op params,
        # so resolve it at node-build time — iteration/len/indexing on
        # the symbol then work like the reference's multi-output symbols
        if opname in ("split", "SliceChannel"):
            n = int(params.get("num_outputs") or params.get("sections")
                    or 1)
        elif opname == "topk":
            n = 2 if params.get("ret_typ") == "both" else 1
        elif opname in ("_sample_multinomial", "sample_multinomial"):
            n = 2 if params.get("get_prob") else 1
        # unknown dynamic op: keep -1 (indexing still yields views)
    return Symbol(opname, params, inputs,
                  name or _auto_name(opname.lower().lstrip("_")),
                  nout=n)


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
        dtype=None, init=None, stype=None, **kwargs):
    """Create a symbolic variable (reference: symbol.py var). ``init``
    (an Initializer or its ``dumps()`` string) is recorded as the
    ``__init__`` attr so bind-time initialization honors it (reference:
    symbol.py var attr handling + initializer.py InitDesc dispatch)."""
    s = Symbol(None, None, [], name, attr=attr)
    if shape is not None:
        s._shape_hint = tuple(shape)
    if dtype is not None:
        s._dtype_hint = dtype
    if init is not None:
        if not isinstance(init, str):
            init = init.dumps()
        s._attr["__init__"] = init
    return s


Variable = var


def Group(symbols):
    """Group symbols into one multi-output symbol
    (reference: symbol.py Group)."""
    symbols = list(symbols)
    g = Symbol("_group", None, symbols, _auto_name("group"),
               nout=len(symbols))
    return g


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str):
    data = json.loads(json_str)
    nodes = data["nodes"]
    built: List[Symbol] = []
    for nd_ in nodes:
        if nd_["op"] == "null":
            s = var(nd_["name"],
                    attr={k: json.loads(v) for k, v in
                          nd_.get("attrs", {}).items()})
        else:
            ins = []
            for (i, oi, _) in nd_["inputs"]:
                src = built[i]
                ins.append(src[oi] if src.num_outputs > 1 else src)
            params = {k: json.loads(v) for k, v in
                      nd_.get("attrs", {}).items()}
            # JSON round-trips tuples as lists; normalize
            params = {k: tuple(v) if isinstance(v, list) else v
                      for k, v in params.items()}
            s = _make_node(nd_["op"], ins, params, name=nd_["name"])
        built.append(s)
    head_idx, head_out, _ = data["heads"][0]
    head = built[head_idx]
    if head.num_outputs > 1 and head_out:
        head = head[head_out]
    return head


def zeros(shape, dtype="float32", **kwargs):
    return _make_node("_zeros", [], {"shape": tuple(shape),
                                     "dtype": dtype})


def ones(shape, dtype="float32", **kwargs):
    return _make_node("_ones", [], {"shape": tuple(shape),
                                    "dtype": dtype})


def arange(start, stop=None, step=1.0, **kwargs):
    return _make_node("_arange", [], {"start": start, "stop": stop,
                                      "step": step})

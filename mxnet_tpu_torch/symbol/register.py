"""Autogeneration of the ``sym.*`` op namespace from the port's registry
(a copy of ``mxnet_tpu/symbol/register.py``).

Mirrors python/mxnet/symbol/register.py codegen: one function per
registered op that builds a graph node instead of executing. Same
positional convention as the nd namespace (leading Symbols are inputs,
further positionals map onto keyword parameters in declaration order).

Parameter-input auto-creation matches the reference's FListInputNames
contract (e.g. ``sym.FullyConnected(data, name='fc1')`` creates
``fc1_weight``/``fc1_bias`` variables) so legacy model-construction code
builds identical graphs.
"""
from __future__ import annotations

from ..ops.registry import _REGISTRY, Operator
from ..ndarray.register import _sig_params

# op -> ordered input names (reference: each op's FListInputNames, e.g.
# src/operator/nn/fully_connected.cc, batch_norm.cc). Inputs not passed
# are auto-created as variables named "{name}_{suffix}".
_OP_INPUT_SUFFIXES = {
    "FullyConnected": ["data", "weight", "bias"],
    "Convolution": ["data", "weight", "bias"],
    "Deconvolution": ["data", "weight", "bias"],
    "BatchNorm": ["data", "gamma", "beta", "moving_mean", "moving_var"],
    "LayerNorm": ["data", "gamma", "beta"],
    "InstanceNorm": ["data", "gamma", "beta"],
    "GroupNorm": ["data", "gamma", "beta"],
    "Embedding": ["data", "weight"],
    "SoftmaxOutput": ["data", "label"],
    "LinearRegressionOutput": ["data", "label"],
    "LogisticRegressionOutput": ["data", "label"],
    "MAERegressionOutput": ["data", "label"],
    "softmax_cross_entropy": ["data", "label"],
    "CTCLoss": ["data", "label"],
    "LeakyReLU": ["data", "gamma"],
    "RNN": ["data", "parameters", "state", "state_cell"],
}

# which suffixes are dropped when a flag param is set
_CONDITIONAL = {
    "bias": ("no_bias", True),
    "gamma": ("act_type", lambda v: v != "prelu"),  # LeakyReLU only
}


def _wanted_suffixes(opname, params):
    suffixes = _OP_INPUT_SUFFIXES.get(opname)
    if suffixes is None:
        return None
    out = []
    for s in suffixes:
        if s == "bias" and params.get("no_bias"):
            continue
        if opname == "LeakyReLU" and s == "gamma" and \
                params.get("act_type", "leaky") != "prelu":
            continue
        if opname == "RNN":
            if s == "state_cell" and params.get("mode") != "lstm":
                continue
        out.append(s)
    return out


def _make_sym_func(op: Operator):
    from .symbol import Symbol, _make_node, _auto_name, var
    pnames, n_pos = _sig_params(op)

    def fn(*args, name=None, **kwargs):
        syms = []
        i = 0
        if op.variadic and args and isinstance(args[0], (list, tuple)):
            syms = list(args[0])
            i = 1
        else:
            while i < len(args) and isinstance(args[i], Symbol):
                syms.append(args[i])
                i += 1
        extra = args[i:]
        params = {}
        kw_inputs = {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                kw_inputs[k] = v
            else:
                params[k] = v
        skip = 1 if op.variadic else min(len(syms), n_pos)
        for v, pname in zip(extra, pnames[skip:]):
            params.setdefault(pname, v)
        explicit_attr = params.pop("attr", None)

        base = name or _auto_name(op.name.lower().lstrip("_"))
        suffixes = _wanted_suffixes(op.name, params)
        if suffixes is not None:
            slots = list(syms)
            # keyword-named inputs land on their declared slot
            for k, v in kw_inputs.items():
                if k in suffixes:
                    pos = suffixes.index(k)
                    while len(slots) <= pos:
                        slots.append(None)
                    slots[pos] = v
            while len(slots) < len(suffixes):
                slots.append(None)
            for pos, s in enumerate(suffixes):
                if slots[pos] is None:
                    vname = f"{base}_{s}" if s != "label" else \
                        f"{base}_label"
                    slots[pos] = var(vname)
            syms = slots
        else:
            syms.extend(kw_inputs.values())
        node = _make_node(op.name, syms, params, name=base)
        # AttrScope attributes (reference: attribute.py AttrScope.get is
        # consulted on every symbol creation)
        from ..attribute import get_current_attrs
        attrs = get_current_attrs(explicit_attr)
        if attrs:
            node._attr = dict(node._attr or {}, **attrs)
        return node

    fn.__name__ = op.name
    fn.__qualname__ = op.name
    fn.__doc__ = op.doc or f"Symbolic wrapper for op {op.name!r}."
    return fn


def _init_symbol_module(module):
    ns = module.__dict__ if not isinstance(module, dict) else module
    for name, op in _REGISTRY.items():
        if name.startswith("_group"):
            continue
        ns.setdefault(name, _make_sym_func(op))

"""``nd.contrib``: the control-flow operators and the contrib op names
(the port of ``mxnet_tpu/ndarray/contrib.py``).

``nd.contrib.X`` resolves the registered op ``_contrib_X``, then ``X``
(``nd.contrib.box_nms``, ``nd.contrib.ROIAlign``,
``nd.contrib.quantize_v2``, ``nd.contrib.quantized_matmul``).

The loops run the user's body eagerly on NDArrays, so they land on
torch's tape step by step and autograd differentiates them as it does
any other code:

- :func:`foreach` runs the body once per slice of the leading axis and
  stacks its outputs;
- :func:`while_loop` keeps the JAX op's semantics: a fixed trip of
  ``max_iterations`` masked steps, where the state and the outputs
  advance only while the condition holds and the output rows after the
  exit are zeros. The condition is never read on the host, so the loop
  costs no synchronisation and can be captured in a CUDA graph (an
  early exit would return fewer rows than the reference);
- :func:`cond` reads its predicate on the host once (one
  synchronisation) and runs one branch; inside a CUDA-graph capture it
  raises, as a ``host_op`` does.
"""
from __future__ import annotations

import torch

from .ndarray import NDArray

__all__ = ["foreach", "while_loop", "cond"]


def _aslist(x):
    if x is None:
        return [], True
    if isinstance(x, (list, tuple)):
        return list(x), False
    return [x], True


def _nd(x):
    return x if isinstance(x, NDArray) else NDArray(x)


def foreach(body, data, init_states):
    """Run ``body(data_t, states) -> (outputs_t, new_states)`` over the
    leading axis of ``data``; returns (the stacked outputs, the final
    states). ``data``, ``init_states`` and the outputs may each be one
    NDArray or a list (a loop without states passes ``None``)."""
    datas, data_single = _aslist(data)
    states, state_single = _aslist(init_states)
    datas = [_nd(d) for d in datas]
    states = [_nd(s) for s in states]
    steps = datas[0].shape[0]
    outs, out_single = [], True
    for t in range(steps):
        xs = [NDArray(d._data[t]) for d in datas]
        s_arg = None if not states else (states[0] if state_single
                                         else states)
        o, new_states = body(xs[0] if data_single else xs, s_arg)
        o_l, out_single = _aslist(o)
        outs.append([_nd(v)._data for v in o_l])
        states = [_nd(v) for v in _aslist(new_states)[0]]
    stacked = [NDArray(torch.stack([step[k] for step in outs]))
               for k in range(len(outs[0]))] if outs else []
    fin = None if not states else (states[0] if state_single else states)
    return (stacked[0] if out_single else stacked), fin


def _as_bool(x):
    return _nd(x)._data.to(torch.bool).reshape(())


def while_loop(cond, func, loop_vars, max_iterations):
    """A bounded while loop: ``cond(*loop_vars)`` a boolean scalar,
    ``func(*loop_vars) -> (step outputs, new loop_vars)``. Returns (the
    stacked outputs, ``max_iterations`` rows, zeros after the exit; the
    final loop_vars). Every step runs ``func`` and keeps its result only
    while the loop is alive: no host read."""
    lvars, single_var = _aslist(loop_vars)
    vars_t = [_nd(v)._data for v in lvars]
    done = None
    rows, out_single = [], True
    for _ in range(int(max_iterations)):
        v_nd = [NDArray(v) for v in vars_t]
        alive = _as_bool(cond(*v_nd))
        if done is not None:
            alive = alive & ~done
        outs, new_vars = func(*v_nd)
        outs_l, out_single = _aslist(outs)
        nv = [_nd(v)._data for v in _aslist(new_vars)[0]]
        vars_t = [torch.where(alive, n, v) for n, v in zip(nv, vars_t)]
        rows.append([torch.where(alive, o, torch.zeros_like(o))
                     for o in (_nd(o)._data for o in outs_l)])
        done = ~alive
    stacked = [NDArray(torch.stack([r[k] for r in rows]))
               for k in range(len(rows[0]))] if rows else []
    fin = [NDArray(v) for v in vars_t]
    return (stacked[0] if out_single else stacked,
            fin[0] if single_var else fin)


def cond(pred, then_func, else_func, inputs):
    """``then_func(*inputs)`` if ``pred(*inputs)`` holds, else
    ``else_func(*inputs)``. The predicate is read on the host (one
    synchronisation), so ``cond`` raises inside a CUDA-graph capture."""
    ins, _ = _aslist(inputs)
    ins = [_nd(x) for x in ins]
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("nd.contrib.cond reads its predicate on the host "
                           "and cannot run inside a CUDA-graph capture")
    branch = then_func if bool(_as_bool(pred(*ins))) else else_func
    return branch(*ins)


def __getattr__(name):
    from .. import ndarray as _nd_mod
    for target in (f"_contrib_{name}", name):
        if target in vars(_nd_mod):
            return vars(_nd_mod)[target]
    raise AttributeError(f"nd.contrib has no attribute {name!r}")

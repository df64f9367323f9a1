"""PyTorch port, ``gluon.rnn``'s cells against the JAX package's
(``mxnet_tpu/gluon/rnn/rnn_cell.py``): ``RNNCell``/``LSTMCell``/
``GRUCell`` unrolled in both layouts, with ``valid_length`` (outputs
masked, states from each sample's last valid step) and
``merge_outputs=False``; ``SequentialRNNCell``, ``ResidualCell``,
``BidirectionalCell`` (also over valid lengths), ``DropoutCell`` at rate
0 in training mode and ``ZoneoutCell`` in inference mode (the gluon half
of ``tests/test_rnn_cells.py``): the outputs, the final states and the
gradients of the input and of every parameter, from the JAX cell's
parameters.

Tolerance: ``RNN_TOL = 2e-5`` of each result's magnitude (f32 products
in torch's order against XLA's over a few steps).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import rnn as jrnn

from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.convert import load_gluon_params
from mxnet_tpu_torch.gluon import rnn as trnn

torch.set_num_threads(2)

RNN_TOL = 2e-5


def _rel_close(got, want, what):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= RNN_TOL * max(np.abs(want).max(), 1.0), (what, err)


def _carry(j, t):
    load_gluon_params(t, {k: v.data().asnumpy()
                          for k, v in j.collect_params().items()})


def _carry_names(j, t):
    """The JAX block's parameters into the port's, name by name (for
    trees whose parameters lie under several root prefixes)."""
    tparams = t.collect_params()
    jparams = j.collect_params()
    assert sorted(tparams.keys()) == sorted(jparams.keys())
    for name, p in jparams.items():
        a = p.data().asnumpy()
        q = tparams[name]
        q.shape = a.shape
        q.set_data(torch.from_numpy(a.copy()))
        q._finish_deferred_init()


def _grads_match(j, t, what):
    tparams = t.collect_params()
    for name, p in j.collect_params().items():
        _rel_close(tparams[name].grad().numpy(), p.grad().asnumpy(),
                   f"{what} {name} grad")


CELLS = [
    ("LSTMCell", {}, "TNC", (5, 2, 3), False),
    ("GRUCell", {}, "NTC", (5, 2, 3), True),
    ("RNNCell", dict(activation="relu"), "NTC", None, False),
    ("RNNCell", {}, "TNC", (4, 5, 1), True),
]


@pytest.mark.parametrize("case", range(len(CELLS)), ids=[
    f"{c[0]}-{c[2]}-{i}" for i, c in enumerate(CELLS)])
def test_cell_unroll_matches_jax(case):
    cls, kw, layout, valid, merge = CELLS[case]
    T, N, H = 5, 3, 6
    j = getattr(jrnn, cls)(H, prefix="cu_", input_size=4, **kw)
    t = getattr(trnn, cls)(H, prefix="cu_", input_size=4, **kw)
    rs = np.random.RandomState(10 + case)
    x = rs.randn(*((N, T, 4) if layout == "NTC" else (T, N, 4))).astype(
        np.float32)
    j.initialize(jmx.initializer.Xavier())
    j.hybridize()
    t.initialize(device="cpu")
    _carry(j, t)
    jx, tx = jmx.nd.array(x), torch.from_numpy(x.copy()).requires_grad_()
    jx.attach_grad()
    kwj, kwt = {}, {}
    if valid is not None:
        vl = np.array(valid, np.float32)
        kwj["valid_length"], kwt["valid_length"] = \
            jmx.nd.array(vl), torch.from_numpy(vl)
    with jag.record():
        jy, js = j.unroll(T, jx, layout=layout, merge_outputs=merge, **kwj)
        if not merge:
            jy = jmx.nd.stack(*jy, axis=0)
    with tag.record():
        ty, ts = t.unroll(T, tx, layout=layout, merge_outputs=merge, **kwt)
    if not merge:
        assert isinstance(ty, list) and len(ty) == T
        ty = torch.stack(ty)
    _rel_close(ty.detach().numpy(), jy.asnumpy(), f"{cls} outputs")
    for a, b in zip(ts, js):
        _rel_close(a.detach().numpy(), b.asnumpy(), f"{cls} state")
    head = rs.randn(*jy.shape).astype(np.float32)
    jy.backward(jmx.nd.array(head))
    ty.backward(torch.from_numpy(head))
    _rel_close(tx.grad.numpy(), jx.grad.asnumpy(), f"{cls} input grad")
    _grads_match(j, t, cls)


def _build_composite(pkg, kind):
    """The composite of ``kind`` over inputs of width 3 (every input size
    given, so no forward is needed to shape the parameters)."""
    if kind == "sequential":
        c = pkg.SequentialRNNCell(prefix="sq_")
        with c.name_scope():
            c.add(pkg.LSTMCell(5, input_size=3))
            c.add(pkg.GRUCell(4, input_size=5))
        return c
    if kind == "residual":
        return pkg.ResidualCell(pkg.GRUCell(3, prefix="res_", input_size=3))
    if kind == "bidirectional":
        return pkg.BidirectionalCell(
            pkg.LSTMCell(4, prefix="bl_", input_size=3),
            pkg.GRUCell(4, prefix="br_", input_size=3))
    if kind == "dropout_zero":
        c = pkg.SequentialRNNCell(prefix="dz_")
        with c.name_scope():
            c.add(pkg.RNNCell(3, input_size=3))
            c.add(pkg.DropoutCell(0.0))
        return c
    return pkg.ZoneoutCell(pkg.LSTMCell(3, prefix="zo_", input_size=3),
                           zoneout_outputs=0.5, zoneout_states=0.5)


@pytest.mark.parametrize("kind,valid", [
    ("sequential", None), ("residual", None), ("bidirectional", None),
    ("bidirectional", (2, 4)), ("dropout_zero", None),
    ("zoneout_inference", None)])
def test_composite_cells_match_jax(kind, valid):
    """Sequential, residual, bidirectional (also over valid lengths, the
    reverse cell reading each sample's real steps first), a dropout of
    rate 0 and zoneout in inference mode: the reference's outputs,
    states and input gradient."""
    T, N = 4, 2
    j, t = _build_composite(jrnn, kind), _build_composite(trnn, kind)
    x = np.random.RandomState(3).randn(N, T, 3).astype(np.float32)
    j.initialize(jmx.initializer.Xavier())
    j.hybridize()
    t.initialize(device="cpu")
    _carry_names(j, t)
    kwj, kwt = {}, {}
    if valid is not None:
        vl = np.array(valid, np.float32)
        kwj["valid_length"], kwt["valid_length"] = \
            jmx.nd.array(vl), torch.from_numpy(vl)
    jx, tx = jmx.nd.array(x), torch.from_numpy(x.copy()).requires_grad_()
    jx.attach_grad()
    train = kind == "dropout_zero"
    with jag.record(train_mode=train):
        jy, js = j.unroll(T, jx, layout="NTC", **kwj)
    with tag.record(train_mode=train):
        ty, ts = t.unroll(T, tx, layout="NTC", **kwt)
    _rel_close(ty.detach().numpy(), jy.asnumpy(), f"{kind} outputs")
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        _rel_close(a.detach().numpy(), b.asnumpy(), f"{kind} state")
    jy.backward()
    ty.backward(torch.ones_like(ty))
    _rel_close(tx.grad.numpy(), jx.grad.asnumpy(), f"{kind} input grad")
    if valid is not None:
        assert np.abs(ty.detach().numpy()[0, valid[0]:]).sum() == 0

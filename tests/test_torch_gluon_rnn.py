"""PyTorch port, ``gluon.rnn`` against the JAX package's
(``mxnet_tpu/gluon/rnn``): the fused ``RNN``/``LSTM``/``GRU`` layers in
both layouts, bidirectional and stacked, with and without states; the
nine cells' ``unroll`` in both layouts, with ``valid_length`` and
``merge_outputs=False``; the outputs, the final states and the gradients
of the input and of every parameter, the JAX block's parameters carried
across by ``convert.load_gluon_params``; the flat packing's order; the
counterparts of ``tests/test_rnn.py`` (layer against cell unroll, the
numpy LSTM oracle, ``begin_state``, hybridize) and of the gluon half of
``tests/test_rnn_cells.py``; dropout and zoneout held by their
invariants (their draws are the port's own).

Tolerance: ``RNN_TOL = 2e-5`` of each result's magnitude (f32 products
in torch's order against XLA's over a few steps).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import rnn as jrnn

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd
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


def _grads_match(j, t, what):
    tparams = t.collect_params()
    for name, p in j.collect_params().items():
        _rel_close(tparams[name].grad().numpy(), p.grad().asnumpy(),
                   f"{what} {name} grad")


LAYERS = [
    ("LSTM", dict(num_layers=2, bidirectional=True), "TNC", False),
    ("GRU", dict(layout="NTC", bidirectional=True), "NTC", True),
    ("RNN", dict(activation="tanh", layout="NTC"), "NTC", False),
    ("RNN", dict(activation="relu", num_layers=2), "TNC", True),
]


@pytest.mark.parametrize("case", range(len(LAYERS)), ids=[
    f"{c[0]}-{c[2]}-{i}" for i, c in enumerate(LAYERS)])
def test_fused_layer_matches_jax(case):
    cls, kw, layout, with_states = LAYERS[case]
    H = 6
    j = getattr(jrnn, cls)(H, prefix="rl_", input_size=4, **kw)
    t = getattr(trnn, cls)(H, prefix="rl_", input_size=4, **kw)
    rs = np.random.RandomState(case)
    x = rs.randn(*((5, 3, 4) if layout == "TNC" else (3, 5, 4))).astype(
        np.float32)
    j.initialize(jmx.initializer.Xavier())
    t.initialize(device="cpu")
    _carry(j, t)
    assert repr(t) == repr(j)
    j.hybridize()
    jx, tx = jmx.nd.array(x), torch.from_numpy(x.copy()).requires_grad_()
    jx.attach_grad()
    if with_states:
        shapes = [s["shape"] for s in j.state_info(3)]
        assert shapes == [s["shape"] for s in t.state_info(3)]
        s0 = [rs.randn(*s).astype(np.float32) for s in shapes]
        with jag.record():
            jy, js = j(jx, [jmx.nd.array(s) for s in s0])
        with tag.record():
            ty, ts = t(tx, [torch.from_numpy(s) for s in s0])
        assert len(ts) == len(js)
        for a, b in zip(ts, js):
            _rel_close(a.detach().numpy(), b.asnumpy(), f"{cls} state")
    else:
        with jag.record():
            jy = j(jx)
        with tag.record():
            ty = t(tx)
    _rel_close(ty.detach().numpy(), jy.asnumpy(), f"{cls} output")
    head = rs.randn(*jy.shape).astype(np.float32)
    jy.backward(jmx.nd.array(head))
    ty.backward(torch.from_numpy(head))
    _rel_close(tx.grad.numpy(), jx.grad.asnumpy(), f"{cls} input grad")
    _grads_match(j, t, cls)


def test_flat_packing_is_the_references():
    """The fused op's flat vector: every weight layer-major and
    direction-minor, then every bias; the same vector in both
    packages."""
    j = jrnn.LSTM(3, num_layers=2, bidirectional=True, input_size=2,
                  prefix="fp_")
    t = trnn.LSTM(3, num_layers=2, bidirectional=True, input_size=2,
                  prefix="fp_")
    j.initialize(jmx.initializer.Uniform(1.0))
    t.initialize(device="cpu")
    _carry(j, t)
    jflat = j._flat_params(jmx.nd, {k[len("fp_"):]: v.data() for k, v in
                                    j.collect_params().items()})
    tflat = t._flat_params({k[len("fp_"):]: v.data() for k, v in
                            t.collect_params().items()})
    np.testing.assert_array_equal(tflat.detach().numpy(), jflat.asnumpy())
    names = [k for k in t.collect_params().keys()]
    assert names == list(j.collect_params().keys())


def _lstm_numpy(x, wx, wh, bx, bh):
    def sig(v):
        return 1 / (1 + np.exp(-v))
    h = np.zeros((x.shape[1], wh.shape[1]), np.float32)
    c = np.zeros_like(h)
    outs = []
    for t in range(x.shape[0]):
        i, f, g, o = np.split(x[t] @ wx.T + bx + h @ wh.T + bh, 4, axis=-1)
        c = sig(f) * c + sig(i) * np.tanh(g)
        h = sig(o) * np.tanh(c)
        outs.append(h)
    return np.stack(outs)


@pytest.mark.parametrize("cls", ["LSTM", "GRU"])
def test_layer_matches_its_cell_and_numpy(cls):
    """The counterpart of ``tests/test_rnn.py``'s layer-against-cell
    tests: the fused layer equals its cell unrolled with the same four
    arrays; the LSTM equals the numpy oracle."""
    T, N, I, H = 5, 2, 4, 8
    layer = getattr(trnn, cls)(H, input_size=I, prefix="lc_")
    layer.initialize(tmx.initializer.Xavier(), device="cpu")
    cell = getattr(trnn, cls + "Cell")(H, input_size=I, prefix="lcc_")
    cell.initialize(device="cpu")
    for name in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        getattr(cell, name).set_data(getattr(layer, "l0_" + name).data())
    x = np.random.RandomState(4).randn(T, N, I).astype(np.float32)
    with tag.pause():
        got = layer(torch.from_numpy(x)).detach()
        want = cell.unroll(T, torch.from_numpy(x), layout="TNC")[0].detach()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    if cls == "LSTM":
        ref = _lstm_numpy(x, *[getattr(layer, "l0_" + n).data().detach()
                               .numpy()
                               for n in ("i2h_weight", "h2h_weight",
                                         "i2h_bias", "h2h_bias")])
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_begin_state_follows_the_input_or_ctx_never_the_cpu_by_default():
    cell = trnn.LSTMCell(4, input_size=3, prefix="bs_")
    cell.initialize(device="cpu")
    layer = trnn.GRU(4, num_layers=2, prefix="bsl_")
    layer.initialize(device="cpu")
    x = torch.randn(2, 5, 3)
    out, states = cell.unroll(5, x)          # states made on x's device
    assert out.shape == (2, 5, 4) and states[0].device == x.device
    assert layer(x.transpose(0, 1)).shape == (5, 2, 4)
    s = cell.begin_state(batch_size=2, ctx=tmx.cpu())
    assert [tuple(v.shape) for v in s] == [(2, 4), (2, 4)]
    s = layer.begin_state(2, func=nd.zeros, ctx="cpu")
    assert [tuple(v.shape) for v in s] == [(2, 2, 4)]
    with tmx.cpu():
        assert cell.begin_state(batch_size=1)[0].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cell.begin_state(batch_size=2)
    mod = trnn.ResidualCell(cell)
    with pytest.raises(RuntimeError):
        cell.begin_state(batch_size=1, ctx="cpu")
    assert len(mod.begin_state(batch_size=1, ctx="cpu")) == 2
    with pytest.raises(NotImplementedError):
        trnn.BidirectionalCell(trnn.RNNCell(2), trnn.RNNCell(2))(x[:, 0],
                                                                 [])


def test_hybridized_layer_and_cell_equal_eager():
    net = trnn.LSTM(4, prefix="hy_")
    net.initialize(device="cpu")
    cell = trnn.GRUCell(4, prefix="hyc_")
    cell.initialize(device="cpu")
    x = torch.randn(3, 2, 5)
    with tag.pause():
        eager, ceager = net(x), cell.unroll(3, x, layout="TNC")[0]
        net.hybridize()
        cell.hybridize()
        for _ in range(2):
            np.testing.assert_array_equal(net(x).numpy(), eager.numpy())
            np.testing.assert_array_equal(
                cell.unroll(3, x, layout="TNC")[0].numpy(), ceager.numpy())


def test_dropout_and_zoneout_training_invariants():
    """Dropout keeps about 1 - rate of the entries, scaled; zoneout's
    output at each step is, entry by entry, the base cell's new output
    or the previous step's output (the draws are the port's own)."""
    x = torch.ones(64, 6, 32)
    d = trnn.DropoutCell(0.25, prefix="dc_")
    with tag.record():
        out, _ = d.unroll(6, x, layout="NTC")
    kept = (out != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.02
    np.testing.assert_allclose(out[out != 0].numpy(), 1 / 0.75, rtol=1e-6)
    base = trnn.RNNCell(8, prefix="zb_")
    base.initialize(device="cpu")
    z = trnn.ZoneoutCell(base, zoneout_outputs=0.5)
    xs = torch.randn(16, 5, 3)
    with tag.record():
        outs, _ = z.unroll(5, xs, layout="NTC", merge_outputs=False)
    # zoneout of the outputs alone leaves the base cell's state chain as
    # it is: its plain unroll gives each step's new output
    with tag.pause():
        plain, _ = base.unroll(5, xs, begin_state=[torch.zeros(16, 8)],
                               layout="NTC", merge_outputs=False)
    prev = torch.zeros_like(outs[0])
    held = 0.0
    for t in range(5):
        new = plain[t].detach()
        got = outs[t].detach()
        assert bool(((got == new) | (got == prev)).all()), t
        held += (got == prev).float().mean().item()
        prev = got
    assert 0.3 < held / 5 < 0.7

"""PyTorch port, the fused RNN op (``mxnet_tpu_torch/ops/rnn.py``) against
the JAX package's on the same numpy inputs and the same flat parameter
vector: all four modes, one and two layers, uni- and bidirectional, at
``p=0``, outputs and VJPs against ``jax.vjp`` (the product tolerance,
rtol 1e-4 / atol 1e-5); the op part of tests/test_rnn.py (the numpy LSTM
oracle); at ``p=0.5`` the dropout keep fraction and that one ``(seed,
position)`` gives one mask (JAX's bernoulli bits are not reproduced).
The gluon RNN layers of tests/test_rnn.py wait with item 13 of
ROADMAP.md.
"""
import importlib.util
import itertools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from mxnet_tpu_torch import _rng, nd  # noqa: E402
from mxnet_tpu_torch.ops.rnn import rnn_param_size  # noqa: E402

torch.set_num_threads(2)
_spec = importlib.util.spec_from_file_location(
    "_tail_main", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "test_torch_op_tail.py"))
_tail = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_tail)
_CASES, _IDS = _tail.cases_for("rnn")

MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")


@pytest.mark.parametrize("name,inputs,kwargs,family", _CASES, ids=_IDS)
def test_op_matches_jax(name, inputs, kwargs, family):
    _tail.run_tail_case(name, inputs, kwargs, family)


@pytest.mark.parametrize("mode,layers,bidir", [
    (m, n, b) for m, n, b in itertools.product(MODES, (1, 2), (False, True))
    if (m, n, b) not in {("lstm", 2, True), ("gru", 2, False),
                         ("rnn_tanh", 1, True), ("rnn_relu", 2, False),
                         ("lstm", 1, False)}])
def test_every_mode_matches_jax(mode, layers, bidir):
    """The modes, depths and directions the corpus cases leave out."""
    inputs, kw = chip_smoke._rnn_case(mode, layers, bidir, seed=200)
    _tail.run_tail_case("RNN", inputs, kw, "nn")


def test_param_size_is_the_reference_layout():
    from mxnet_tpu.ops.rnn import rnn_param_size as jax_size
    for mode, layers, bidir in itertools.product(MODES, (1, 3),
                                                 (False, True)):
        assert rnn_param_size(7, 5, layers, mode, bidir) == \
            jax_size(7, 5, layers, mode, bidir)


def _np_lstm_ref(x, h0, c0, wx, wh, bx, bh):
    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))
    h, c = h0.copy(), c0.copy()
    outs = []
    for t in range(x.shape[0]):
        gates = x[t] @ wx.T + bx + h @ wh.T + bh
        i, f, g, o = np.split(gates, 4, axis=-1)
        c = sig(f) * c + sig(i) * np.tanh(g)
        h = sig(o) * np.tanh(c)
        outs.append(h)
    return np.stack(outs), h, c


def test_lstm_matches_numpy():
    T, N, I, H = 4, 3, 5, 6
    rng = np.random.RandomState(0)
    x = rng.randn(T, N, I).astype("f")
    wx = rng.randn(4 * H, I).astype("f") * 0.3
    wh = rng.randn(4 * H, H).astype("f") * 0.3
    bx = rng.randn(4 * H).astype("f") * 0.1
    bh = rng.randn(4 * H).astype("f") * 0.1
    h0 = np.zeros((1, N, H), "f")
    flat = np.concatenate([wx.ravel(), wh.ravel(), bx, bh])
    out, ht, ct = nd.RNN(*[nd.array(a, ctx="cpu") for a in (x, flat, h0,
                                                             h0)],
                         state_size=H, num_layers=1, mode="lstm")
    ref_out, ref_h, ref_c = _np_lstm_ref(x, h0[0], h0[0], wx, wh, bx, bh)
    np.testing.assert_allclose(out.asnumpy(), ref_out, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ht.asnumpy()[0], ref_h, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ct.asnumpy()[0], ref_c, rtol=1e-4, atol=1e-5)


def _dropout_run(seed, p, train=True):
    """Two 64-wide layers at ``p``; the first layer's output is where the
    mask lands: returns (the op's output, the mask the second layer saw,
    recovered by running the second layer's input through)."""
    inputs, kw = chip_smoke._rnn_case("rnn_relu", 2, False, seed=300,
                                      t=6, n=8, i=3, h=64)
    arrs = [nd.array(a.astype(np.float32), ctx="cpu") for a in inputs]
    _rng.seed(seed)
    from mxnet_tpu_torch import autograd as ag
    with ag.record(train_mode=train):
        out = nd.RNN(*arrs, **dict(kw, p=p))[0]
    return out.asnumpy()


def test_dropout_keep_fraction_and_stream():
    """At p=0.5 in training, the layer-1 output reaching layer 2 keeps
    about half its entries, scaled by 2: held through the op's own
    arithmetic, the mask read back from ``rnn_forward`` with a recorded
    generator; the same seed and position give the same output, another
    seed another; outside training nothing is dropped."""
    from mxnet_tpu_torch.ops import rnn as trnn
    inputs, kw = chip_smoke._rnn_case("rnn_relu", 2, False, seed=300,
                                      t=6, n=8, i=3, h=64)
    ts = [torch.from_numpy(a.astype(np.float32)) for a in inputs]
    gen = _rng.generator_for(11, 0)
    seen = []
    orig = torch.where

    def spy(cond, *a, **k):
        if cond.dtype == torch.bool and cond.shape == (6, 8, 64):
            seen.append(cond.clone())
        return orig(cond, *a, **k)
    torch.where = spy
    try:
        trnn.rnn_forward(ts[0], ts[1], ts[2], None, "rnn_relu", 64, 2,
                         p=0.5, training=True, rng=gen)
    finally:
        torch.where = orig
    assert len(seen) == 1
    frac = float(seen[0].float().mean())
    n = seen[0].numel()
    assert abs(frac - 0.5) < 4 * np.sqrt(0.25 / n)
    a = _dropout_run(3, 0.5)
    b = _dropout_run(3, 0.5)
    c = _dropout_run(4, 0.5)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.array_equal(_dropout_run(3, 0.5, train=False),
                          _dropout_run(3, 0.0))


def test_projection_size_raises():
    inputs, kw = chip_smoke._rnn_case("lstm", 1, False, seed=1)
    with pytest.raises(NotImplementedError):
        nd.RNN(*[nd.array(a, ctx="cpu") for a in inputs],
               **dict(kw, projection_size=2))


def test_rnn_alias_and_vanilla_cell_zero_state():
    """``nd.rnn`` is ``nd.RNN``; GRU and the vanilla modes return a zero
    cell state, as the JAX op."""
    inputs, kw = chip_smoke._rnn_case("gru", 1, True, seed=5)
    arrs = [nd.array(a, ctx="cpu") for a in inputs]
    a = nd.RNN(*arrs, **kw)
    b = nd.rnn(*arrs, **kw)
    for x, y in zip(a, b):
        assert np.array_equal(x.asnumpy(), y.asnumpy())
    assert not a[2].asnumpy().any()

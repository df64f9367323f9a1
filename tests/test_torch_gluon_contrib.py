"""PyTorch port, ``gluon.contrib`` against the JAX package's
(``mxnet_tpu/gluon/contrib``): ``Concurrent``/``HybridConcurrent`` with
``Identity``, the three ``PixelShuffle`` layers, ``SparseEmbedding``'s
row-sparse gradient, ``SyncBatchNorm`` on one device (its output, input
and parameter gradients and running statistics), ``LSTMPCell`` and the
nine convolutional cells (forward, states and gradients from the JAX
cell's parameters), ``VariationalDropoutCell`` (inference against the
reference; in training one mask a sequence, as the reference's test
holds), ``SyncBatchNorm(axis_name=...)`` raising with ROADMAP.md §1 item
9 named and ``gluon.contrib.estimator`` with item 13e named: the
counterparts of ``tests/test_gluon_contrib_nn.py`` and
``tests/test_gluon_contrib_rnn.py``.

Tolerance: ``CONTRIB_TOL = 2e-5`` of each result's magnitude (f32 sums
of a convolution or a normalisation in torch's order against XLA's).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.gluon.contrib import nn as jcnn
from mxnet_tpu.gluon.contrib import rnn as jcrnn

from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.convert import load_gluon_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.gluon.contrib import nn as tcnn
from mxnet_tpu_torch.gluon.contrib import rnn as tcrnn
from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray

torch.set_num_threads(2)

CONTRIB_TOL = 2e-5


def _rel_close(got, want, what):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= CONTRIB_TOL * max(np.abs(want).max(), 1.0), (what, err)


def _carry(j, t):
    load_gluon_params(t, {k: v.data().asnumpy()
                          for k, v in j.collect_params().items()})


def _run_pair(j, t, args, record=True):
    """Both blocks on the same inputs (lists of arrays pass as state
    lists); returns the outputs flattened, and the input gradients
    after a backward of the first output."""
    jargs = [[jmx.nd.array(a) for a in v] if isinstance(v, list)
             else jmx.nd.array(v) for v in args]
    targs = [[torch.from_numpy(a.copy()) for a in v] if isinstance(v, list)
             else torch.from_numpy(v.copy()).requires_grad_()
             for v in args]
    jargs[0].attach_grad()
    with jag.record(train_mode=record):
        jy = j(*jargs)
    with tag.record(train_mode=record):
        ty = t(*targs)

    def flat(y):
        if isinstance(y, (list, tuple)):
            return [v for x in y for v in flat(x)]
        return [y]
    jf, tf = flat(jy), flat(ty)
    assert len(jf) == len(tf)
    for a, b in zip(tf, jf):
        _rel_close(a.detach().numpy(), b.asnumpy(), "output")
    jf[0].backward()
    tf[0].backward(torch.ones_like(tf[0]))
    _rel_close(targs[0].grad.numpy(), jargs[0].grad.asnumpy(), "input grad")
    return jf, tf


def test_concurrent_with_identity_matches_jax():
    def build(nn, cnn):
        net = cnn.HybridConcurrent(axis=1, prefix="cc_")
        with net.name_scope():
            net.add(nn.Dense(4, in_units=3), cnn.Identity(),
                    nn.Dense(2, in_units=3))
        return net
    j, t = build(jnn, jcnn), build(tnn, tcnn)
    x = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    j.initialize(jmx.initializer.Xavier())
    t.initialize(device="cpu")
    _carry(j, t)
    _run_pair(j, t, [x])
    with tag.pause():
        eager = t(torch.from_numpy(x)).numpy()
        t.hybridize()
        np.testing.assert_array_equal(t(torch.from_numpy(x)).numpy(), eager)
    seq = tcnn.Concurrent(axis=-1, prefix="cs_")
    seq.add(tcnn.Identity(), tcnn.Identity())
    assert tuple(seq(torch.ones(2, 3)).shape) == (2, 6)


@pytest.mark.parametrize("cls,factor,shape", [
    ("PixelShuffle1D", 2, (2, 6, 5)),
    ("PixelShuffle2D", (2, 3), (1, 12, 3, 2)),
    ("PixelShuffle3D", 2, (1, 16, 2, 1, 3))])
def test_pixel_shuffle_matches_jax(cls, factor, shape):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    j, t = getattr(jcnn, cls)(factor), getattr(tcnn, cls)(factor)
    want = j(jmx.nd.array(x)).asnumpy()
    got = t(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert repr(t) == repr(j)
    if cls == "PixelShuffle2D":
        np.testing.assert_array_equal(
            tcnn.PixelShuffle2D(2)(torch.arange(16.).reshape(1, 4, 2, 2))
            .numpy(), torch.nn.functional.pixel_shuffle(
                torch.arange(16.).reshape(1, 4, 2, 2), 2).numpy())


def test_sparse_embedding_has_a_row_sparse_gradient():
    emb = tcnn.SparseEmbedding(50, 4, prefix="se_")
    emb.initialize(device="cpu")
    assert list(emb.collect_params().keys()) == ["se_weight"]
    with tag.record():
        loss = (emb(torch.tensor([1, 9, 9])) ** 2).sum()
    loss.backward()
    g = emb.weight.grad()
    assert isinstance(g, RowSparseNDArray)
    w = emb.weight.data().detach().numpy()
    dense = np.zeros_like(w)
    dense[1] = 2 * w[1]
    dense[9] = 4 * w[9]
    np.testing.assert_allclose(g.asnumpy(), dense, rtol=1e-6)
    assert repr(emb).startswith("SparseEmbedding(50 -> 4")


def test_sync_batch_norm_on_one_device_matches_jax():
    j = jcnn.SyncBatchNorm(in_channels=3, prefix="sbn_")
    t = tcnn.SyncBatchNorm(in_channels=3, prefix="sbn_")
    x = np.random.RandomState(2).randn(8, 3, 6).astype(np.float32)
    j.initialize()
    t.initialize(device="cpu")
    _carry(j, t)
    _run_pair(j, t, [x])
    tp = t.collect_params()
    for name, p in j.collect_params().items():
        _rel_close(tp[name].data().detach().numpy(), p.data().asnumpy(),
                   name)
        if p.grad_req != "null":
            _rel_close(tp[name].grad().numpy(), p.grad().asnumpy(),
                       f"{name} grad")
    assert isinstance(t, tnn.BatchNorm)


def test_sync_batch_norm_across_devices_names_item_9():
    with pytest.raises(NotImplementedError, match=r"§1 item 9"):
        tcnn.SyncBatchNorm(in_channels=3, axis_name="dp")


def test_estimator_resolves_and_fits():
    est_mod = gluon.contrib.estimator
    assert gluon.contrib.nn is tcnn and gluon.contrib.rnn is tcrnn
    net = tnn.Dense(2, prefix="estfit_")
    net.initialize(device="cpu")
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(8, 3).astype(np.float32))
    y = torch.from_numpy((np.arange(8) % 2).astype(np.float32))
    est = est_mod.Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss())
    est.fit([(x, y)] * 2, epochs=2)
    name, acc = est.train_metrics[0].get()
    assert name == "accuracy" and 0.0 <= acc <= 1.0
    assert est.trainer._step_count == 4


CONV_CELLS = [
    ("Conv1DRNNCell", (2, 6), {}),
    ("Conv1DLSTMCell", (2, 6), dict(i2h_kernel=1)),
    ("Conv1DGRUCell", (2, 6), dict(activation="relu")),
    ("Conv2DRNNCell", (2, 4, 5), dict(activation="relu")),
    ("Conv2DLSTMCell", (3, 4, 4), {}),
    ("Conv2DGRUCell", (2, 3, 5), dict(i2h_kernel=(1, 3))),
    ("Conv3DRNNCell", (1, 2, 3, 3), {}),
    ("Conv3DLSTMCell", (1, 3, 2, 3), dict(h2h_kernel=1)),
    ("Conv3DGRUCell", (2, 2, 2, 3), {}),
]


@pytest.mark.parametrize("case", range(len(CONV_CELLS)),
                         ids=[c[0] for c in CONV_CELLS])
def test_conv_cells_match_jax(case):
    cls, in_shape, kw = CONV_CELLS[case]
    j = getattr(jcrnn, cls)(in_shape, 3, prefix="cv_", **kw)
    t = getattr(tcrnn, cls)(in_shape, 3, prefix="cv_", **kw)
    rs = np.random.RandomState(case)
    x = rs.randn(2, *in_shape).astype(np.float32)
    j.initialize(jmx.initializer.Xavier())
    j.hybridize()
    t.initialize(device="cpu")
    assert [s["shape"] for s in t.state_info(2)] == \
        [s["shape"] for s in j.state_info(2)]
    states = [rs.randn(*s["shape"]).astype(np.float32) * 0.5
              for s in j.state_info(2)]
    _carry(j, t)
    _run_pair(j, t, [x, states])
    tp = t.collect_params()
    for name, p in j.collect_params().items():
        _rel_close(tp[name].grad().numpy(), p.grad().asnumpy(),
                   f"{name} grad")


def test_lstmp_cell_unroll_matches_jax():
    j = jcrnn.LSTMPCell(8, 3, prefix="lp_", input_size=5)
    t = tcrnn.LSTMPCell(8, 3, prefix="lp_", input_size=5)
    x = np.random.RandomState(5).randn(2, 4, 5).astype(np.float32)
    j.initialize(jmx.initializer.Xavier())
    j.hybridize()
    t.initialize(device="cpu")
    _carry(j, t)

    class _Unroll:
        def __init__(self, cell):
            self.cell = cell

        def __call__(self, x):
            out, states = self.cell.unroll(4, x, layout="NTC")
            return [out] + list(states)
    _run_pair(_Unroll(j), _Unroll(t), [x])
    tp = t.collect_params()
    for name, p in j.collect_params().items():
        _rel_close(tp[name].grad().numpy(), p.grad().asnumpy(),
                   f"{name} grad")


def test_variational_dropout_cell():
    """Inference: the base cell, as the reference's. Training: one mask a
    sequence (the same output units dropped at every step), drawn anew
    after ``reset``; the kept units scaled by 1 / (1 - rate)."""
    jb = jrnn.LSTMCell(8, prefix="vd_", input_size=5)
    tb = trnn.LSTMCell(8, prefix="vd_", input_size=5)
    j = jcrnn.VariationalDropoutCell(jb, drop_inputs=0.3, drop_outputs=0.5)
    t = tcrnn.VariationalDropoutCell(tb, drop_inputs=0.3, drop_outputs=0.5)
    x = np.random.RandomState(6).randn(4, 3, 5).astype(np.float32)
    j.initialize(jmx.initializer.Xavier())
    t.initialize(device="cpu")
    _carry(jb, tb)
    with tag.pause():
        got, _ = t.unroll(3, torch.from_numpy(x))
    want, _ = j.unroll(3, jmx.nd.array(x))
    _rel_close(got.numpy(), want.asnumpy(), "inference")
    ones = torch.ones(2, 5)
    with tag.record():
        s = t.begin_state(batch_size=2, ctx="cpu")
        out1, s = t(ones, s)
        out2, _ = t(ones, s)
    m1, m2 = out1 == 0, out2 == 0
    assert torch.equal(m1, m2) and bool(m1.any())
    t.reset()
    masks = set()
    for _ in range(4):
        t.reset()
        with tag.record():
            o, _ = t(ones, t.begin_state(batch_size=2, ctx="cpu"))
        masks.add(tuple((o == 0).flatten().tolist()))
    assert len(masks) > 1
    assert repr(t).startswith("VariationalDropoutCell(in=0.3")

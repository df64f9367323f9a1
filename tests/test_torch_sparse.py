"""PyTorch port, the sparse tier (``mxnet_tpu_torch/ndarray/sparse.py``,
the sparse Embedding gradient of ``ops/invoke.py``, ``autograd``'s and
``Parameter``'s row-sparse gradients, the lazy SGD/Adam updates, the
fused updater's and the compiled step's ``sparse_grad`` fallbacks)
against the JAX package on the same numpy inputs, on the CPU.

One counterpart for each test of tests/test_sparse.py (the same
names), then the port's own cases: ``_contrib_SparseEmbedding``, the
ids' order when a row repeats and across two lookups, ``grad_req="add"``,
``autograd.grad``'s sparse result and the two fallback labels.

Tolerances: storage, ids, sparse sums and densified arrays exact;
``sparse.dot`` forward and gradient rtol 1e-5 / atol 1e-6 (a sum over
a row in another order than XLA's segment sum); the lazy updates
against the reference rtol 1e-6 / atol 1e-7 on the touched rows (the
same operations in the same order; kept off exact for XLA's CPU
contractions), untouched rows bit for bit.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.ndarray import sparse as jsparse
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.ndarray import sparse

torch.set_num_threads(2)
CPU = "cpu"
DOT_TOL = dict(rtol=1e-5, atol=1e-6)
LAZY_TOL = dict(rtol=1e-6, atol=1e-7)


def test_row_sparse_lazy_storage():
    vals = np.ones((2, 3), np.float32)
    r = sparse.row_sparse_array((vals, [1, 4]), shape=(6, 3), ctx=CPU)
    j = jsparse.row_sparse_array((vals, [1, 4]), shape=(6, 3))
    assert r.stype == "row_sparse" == j.stype
    assert r.shape == (6, 3) and r.ndim == 2 and r.size == 18
    assert not r.densified and r.context.device_type == "cpu"
    np.testing.assert_array_equal(r.indices.asnumpy(), j.indices.asnumpy())
    np.testing.assert_array_equal(r.data.asnumpy(), j.data.asnumpy())
    dense = r.asnumpy()
    assert r.densified
    np.testing.assert_array_equal(dense, j.asnumpy())


def test_row_sparse_from_dense_and_tostype():
    d = np.zeros((5, 2), np.float32)
    d[0] = [1, 2]
    d[3] = [3, 4]
    r, j = sparse.row_sparse_array(d, ctx=CPU), jsparse.row_sparse_array(d)
    np.testing.assert_array_equal(r.indices.asnumpy(), j.indices.asnumpy())
    np.testing.assert_array_equal(r.tostype("default").asnumpy(), d)
    back = sparse.cast_storage(nd.array(d, ctx=CPU), "row_sparse")
    assert isinstance(back, sparse.RowSparseNDArray)
    np.testing.assert_array_equal(back.asnumpy(), d)
    csr = r.tostype("csr")
    assert csr.stype == "csr"
    np.testing.assert_array_equal(csr.asnumpy(), d)


def test_csr_roundtrip_and_spmm():
    rng = np.random.RandomState(0)
    a = rng.randn(6, 8).astype(np.float32)
    a[a < 0.5] = 0
    c, jc = sparse.csr_matrix(a, ctx=CPU), jsparse.csr_matrix(a)
    for part in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(c, part).asnumpy(),
                                      getattr(jc, part).asnumpy())
    np.testing.assert_array_equal(c.asnumpy(), a)
    c2 = sparse.csr_matrix(a, ctx=CPU)
    b = rng.randn(8, 4).astype(np.float32)
    out = sparse.dot(c2, nd.array(b, ctx=CPU))
    want = jsparse.dot(jsparse.csr_matrix(a), jnd.array(b))
    np.testing.assert_allclose(out.asnumpy(), want.asnumpy(), **DOT_TOL)
    assert not c2.densified
    bt = rng.randn(6, 4).astype(np.float32)
    out_t = sparse.dot(c2, nd.array(bt, ctx=CPU), transpose_a=True)
    want_t = jsparse.dot(jsparse.csr_matrix(a), jnd.array(bt),
                         transpose_a=True)
    np.testing.assert_allclose(out_t.asnumpy(), want_t.asnumpy(), **DOT_TOL)
    assert not c2.densified


def test_csr_dot_gradient_flows():
    """The gradient to the dense side, csr.T @ dy (and csr @ dy for the
    transposed product), against the reference's tape."""
    rng = np.random.RandomState(0)
    lhs = (rng.rand(6, 8) < 0.3).astype(np.float32) * \
        rng.randn(6, 8).astype(np.float32)
    for transpose_a, wshape, dshape in ((False, (8, 3), (6, 3)),
                                        (True, (6, 3), (8, 3))):
        w_np = rng.randn(*wshape).astype(np.float32)
        dy = rng.randn(*dshape).astype(np.float32)
        w = nd.array(w_np, ctx=CPU)
        w.attach_grad()
        with ag.record():
            out = sparse.dot(sparse.csr_matrix(lhs, ctx=CPU), w,
                             transpose_a=transpose_a)
            loss = (out * nd.array(dy, ctx=CPU)).sum()
        loss.backward()
        jw = jnd.array(w_np)
        jw.attach_grad()
        with jag.record():
            jout = jsparse.dot(jsparse.csr_matrix(lhs), jw,
                               transpose_a=transpose_a)
            jloss = (jout * jnd.array(dy)).sum()
        jloss.backward()
        np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), **DOT_TOL)
        np.testing.assert_allclose(w.grad.asnumpy(), jw.grad.asnumpy(),
                                   **DOT_TOL)


def test_csr_dot_vector_rhs():
    rng = np.random.RandomState(1)
    lhs = (rng.rand(5, 7) < 0.4).astype(np.float32) * \
        rng.randn(5, 7).astype(np.float32)
    c, jc = sparse.csr_matrix(lhs, ctx=CPU), jsparse.csr_matrix(lhs)
    for transpose_a, n in ((False, 7), (True, 5)):
        v = rng.randn(n).astype(np.float32)
        out = sparse.dot(c, nd.array(v, ctx=CPU), transpose_a=transpose_a)
        want = jsparse.dot(jc, jnd.array(v), transpose_a=transpose_a)
        assert out.shape == want.shape == ((7,) if transpose_a else (5,))
        np.testing.assert_allclose(out.asnumpy(), want.asnumpy(), **DOT_TOL)


def test_retain():
    vals = np.arange(6, dtype=np.float32).reshape(3, 2)
    r = sparse.row_sparse_array((vals, [1, 4, 5]), shape=(7, 2), ctx=CPU)
    j = jsparse.row_sparse_array((vals, [1, 4, 5]), shape=(7, 2))
    kept, jkept = sparse.retain(r, [4, 6]), jsparse.retain(j, [4, 6])
    np.testing.assert_array_equal(kept.indices.asnumpy(),
                                  jkept.indices.asnumpy())
    np.testing.assert_array_equal(kept.data.asnumpy(), jkept.data.asnumpy())
    np.testing.assert_array_equal(kept.asnumpy(), jkept.asnumpy())
    with pytest.raises(TypeError):
        sparse.retain(nd.array(vals, ctx=CPU), [1])


def test_sparse_add_stays_sparse():
    one = np.ones((1, 2), np.float32)
    two = np.ones((2, 2), np.float32)
    s = sparse.add(sparse.row_sparse_array((one, [0]), shape=(4, 2),
                                           ctx=CPU),
                   sparse.row_sparse_array((two, [0, 2]), shape=(4, 2),
                                           ctx=CPU))
    js = jsparse.add(jsparse.row_sparse_array((one, [0]), shape=(4, 2)),
                     jsparse.row_sparse_array((two, [0, 2]), shape=(4, 2)))
    assert s.stype == "row_sparse" and not s.densified
    np.testing.assert_array_equal(s.indices.asnumpy(), js.indices.asnumpy())
    np.testing.assert_array_equal(s.asnumpy(), js.asnumpy())


def _embeddings(vocab, dim, sparse_grad=True, grad_req="write"):
    """The port's and the reference's Embedding with the same weights
    (the reference's seeded init, copied into the port's)."""
    mx.random.seed(0)
    j = jgluon.nn.Embedding(vocab, dim, sparse_grad=sparse_grad,
                            prefix="jemb_")
    j.initialize()
    t = gluon.nn.Embedding(vocab, dim, sparse_grad=sparse_grad,
                           prefix="temb_")
    t.initialize(device=CPU)
    t.weight.set_data(torch.from_numpy(j.weight.data().asnumpy().copy()))
    if grad_req != "write":
        j.weight.grad_req = t.weight.grad_req = grad_req
    return t, j


def _backward(t, j, ids, passes=1):
    for _ in range(passes):
        with ag.record():
            loss = (t(nd.array(ids, ctx=CPU)) ** 2).sum()
        loss.backward()
        with jag.record():
            jloss = (j(jnd.array(ids)) ** 2).sum()
        jloss.backward()
    return t.weight.grad(), j.weight.grad()


def test_embedding_sparse_grad():
    """A RowSparseNDArray of the looked-up rows, never densified, its ids
    and rows the reference's; densified, the dense gradient's."""
    t, j = _embeddings(1000, 4)
    assert t.weight.grad_stype == "row_sparse"
    g, jg = _backward(t, j, np.array([[1, 3], [3, 7]]))
    assert isinstance(g, sparse.RowSparseNDArray) and not g.densified
    np.testing.assert_array_equal(g.indices.asnumpy(), jg.indices.asnumpy())
    np.testing.assert_array_equal(g.data.asnumpy(), jg.data.asnumpy())
    dense, _ = _embeddings(1000, 4, sparse_grad=False)
    dense.weight.set_data(t.weight.data().detach().clone())
    with ag.record():
        loss = (dense(nd.array(np.array([[1, 3], [3, 7]]), ctx=CPU))
                ** 2).sum()
    loss.backward()
    np.testing.assert_array_equal(g.asnumpy(), dense.weight.grad().numpy())


@pytest.mark.parametrize("opt,kwargs", [
    ("sgd", {"learning_rate": 0.5}),
    ("sgd", {"learning_rate": 0.5, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.1}),
])
def test_lazy_update_touches_only_grad_rows(opt, kwargs):
    """Two steps of the port's and the reference's Trainer on the same
    ids (one repeated): the same rows change, by the same amounts; every
    other row, and its states, keeps its bits."""
    t, j = _embeddings(64, 3)
    w0 = t.weight.data().detach().clone()
    tr = gluon.Trainer(t.collect_params(), opt, dict(kwargs))
    jtr = jgluon.Trainer(j.collect_params(), opt, dict(kwargs))
    untouched = [i for i in range(64) if i not in (2, 5, 9)]
    for k in range(2):
        _backward(t, j, np.array([2, 5, 5, 9]))
        tr.step(1)
        jtr.step(1)
        w1 = t.weight.data().detach()
        if k == 0:
            changed = set(np.where((w1 != w0).any(dim=1).numpy())[0]
                          .tolist())
            assert changed == {2, 5, 9}
        assert torch.equal(w1[untouched], w0[untouched])
        states = tr._updaters[0].states[0]
        for s in (states if isinstance(states, tuple) else (states,)):
            if s is not None:
                assert not s[untouched].any()
        np.testing.assert_allclose(w1.numpy(), j.weight.data().asnumpy(),
                                   **LAZY_TOL)


def test_lazy_sgd_matches_dense_on_touched_rows():
    from mxnet_tpu import optimizer as jopt
    from mxnet_tpu_torch import optimizer as topt
    vals = np.array([[1.0, -2.0], [0.5, 0.25]], np.float32)
    w = np.arange(10, dtype=np.float32).reshape(5, 2)
    o = topt.SGD(learning_rate=0.1, momentum=0.9, wd=0.01)
    weight = torch.from_numpy(w.copy())
    state = o.create_state(0, weight)
    o.update(0, weight, sparse.row_sparse_array((vals, [1, 3]), shape=(5, 2),
                                                ctx=CPU), state)
    jo = jopt.SGD(learning_rate=0.1, momentum=0.9, wd=0.01)
    jw = jnd.array(w.copy())
    jo.update(0, jw, jsparse.row_sparse_array((vals, [1, 3]), shape=(5, 2)),
              jo.create_state(0, jw))
    expect = w.copy()
    expect[[1, 3]] = w[[1, 3]] - 0.1 * (vals + 0.01 * w[[1, 3]])
    np.testing.assert_allclose(weight.numpy(), expect, rtol=1e-5)
    np.testing.assert_allclose(weight.numpy(), jw.asnumpy(), **LAZY_TOL)
    assert torch.equal(weight[[0, 2, 4]], torch.from_numpy(w[[0, 2, 4]]))


def test_kvstore_row_sparse_pull_and_sparse_push():
    from mxnet_tpu_torch import kvstore
    val = np.arange(12, dtype=np.float32).reshape(6, 2)
    outs = []
    for kvs, arr, sp in ((kvstore, lambda a: nd.array(a, ctx=CPU), sparse),
                         (mx.kv, jnd.array, jsparse)):
        kv = kvs.create("local")
        kv.init(3, arr(val))
        kw = {"ctx": CPU} if sp is sparse else {}
        out = sp.zeros("row_sparse", (6, 2), **kw)
        kv.row_sparse_pull(3, out=out, row_ids=arr(np.array([1, 4, 4])))
        assert not out.densified
        g1 = sp.row_sparse_array((np.ones((1, 2), np.float32), [0]),
                                 shape=(6, 2), **kw)
        g2 = sp.row_sparse_array((np.ones((1, 2), np.float32), [2]),
                                 shape=(6, 2), **kw)
        kv.init(4, sp.zeros("row_sparse", (6, 2), **kw))
        kv.push(4, [g1, g2])
        assert kv._store[4].stype == "row_sparse"
        pulled = arr(np.zeros((6, 2), np.float32))
        kv.pull(4, out=pulled)
        outs.append((out.indices.asnumpy(), out.data.asnumpy(),
                     pulled.asnumpy()))
    for got, want in zip(*outs):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(outs[0][1], val[[1, 4]])


def test_parameter_row_sparse_data():
    from mxnet_tpu_torch.gluon import Parameter
    p = Parameter("w", shape=(8, 3), stype="row_sparse")
    p.initialize(device=CPU)
    rows = p.row_sparse_data(nd.array(np.array([6, 0, 6]), ctx=CPU))
    assert isinstance(rows, sparse.RowSparseNDArray)
    assert p.list_row_sparse_data(torch.tensor([0]))[0].indices.asnumpy() \
        .tolist() == [0]
    np.testing.assert_array_equal(rows.indices.asnumpy(), [0, 6])
    np.testing.assert_array_equal(rows.data.asnumpy(),
                                  p.data().detach().numpy()[[0, 6]])
    jp = jgluon.Parameter("jw", shape=(8, 3), stype="row_sparse")
    jp.initialize()
    jrows = jp.row_sparse_data(jnd.array(np.array([6, 0, 6])))
    np.testing.assert_array_equal(rows.indices.asnumpy(),
                                  jrows.indices.asnumpy())


# ------------------------------------------------------ the port's own --
def test_contrib_sparse_embedding_grad():
    """``nd._contrib_SparseEmbedding`` on an attached weight: the
    reference's RowSparseNDArray gradient."""
    rng = np.random.RandomState(3)
    w_np = rng.randn(10, 4).astype(np.float32)
    ids = np.array([[4, 1], [4, 8]], np.float32)
    w = nd.array(w_np, ctx=CPU)
    w.attach_grad()
    with ag.record():
        out = nd._contrib_SparseEmbedding(nd.array(ids, ctx=CPU), w,
                                          input_dim=10, output_dim=4)
        loss = (out * out).sum()
    loss.backward()
    jw = jnd.array(w_np)
    jw.attach_grad()
    with jag.record():
        jout = jnd._contrib_SparseEmbedding(jnd.array(ids), jw,
                                            input_dim=10, output_dim=4)
        jloss = (jout * jout).sum()
    jloss.backward()
    assert isinstance(w.grad, sparse.RowSparseNDArray)
    np.testing.assert_array_equal(w.grad.indices.asnumpy(),
                                  jw.grad.indices.asnumpy())
    np.testing.assert_array_equal(w.grad.data.asnumpy(),
                                  jw.grad.data.asnumpy())


def test_repeated_ids_keep_the_reference_order():
    """One lookup of ``[2, 5, 5, 9]``: the ids as looked up, repeats kept
    (the reference's). Two lookups of one table in one backward: each
    lookup's ids in its order; torch's accumulation lists the lookups in
    forward order, the reference's tape in reverse; the rows they sum
    to are the same."""
    t, j = _embeddings(16, 2)
    g, jg = _backward(t, j, np.array([2, 5, 5, 9]))
    assert g.indices.asnumpy().tolist() == [2, 5, 5, 9] == \
        jg.indices.asnumpy().tolist()
    a, b = np.array([1, 3]), np.array([7, 5])
    with ag.record():
        loss = t(nd.array(a, ctx=CPU)).sum() + \
            2 * t(nd.array(b, ctx=CPU)).sum()
    loss.backward()
    with jag.record():
        jloss = j(jnd.array(a)).sum() + 2 * j(jnd.array(b)).sum()
    jloss.backward()
    g, jg = t.weight.grad(), j.weight.grad()
    assert g.indices.asnumpy().tolist() == [1, 3, 7, 5]
    assert jg.indices.asnumpy().tolist() == [7, 5, 1, 3]
    np.testing.assert_array_equal(g.asnumpy(), jg.asnumpy())


def test_grad_req_add_accumulates_densely():
    """``grad_req="add"`` sums a row-sparse gradient into the dense
    gradient the parameter starts from: a dense result, the
    reference's."""
    t, j = _embeddings(12, 3, grad_req="add")
    g, jg = _backward(t, j, np.array([1, 4, 4]), passes=2)
    assert not isinstance(g, sparse.RowSparseNDArray) and g.shape == (12, 3)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg.asnumpy()))
    x = nd.array(np.ones((5, 2), np.float32), ctx=CPU)
    x.attach_grad(grad_req="add")
    w = nd.array(np.arange(10, dtype=np.float32).reshape(5, 2), ctx=CPU)
    w.attach_grad(grad_req="add")
    for _ in range(2):
        with ag.record():
            out = nd.Embedding(nd.array([0, 3], ctx=CPU), w, input_dim=5,
                               output_dim=2, sparse_grad=True)
        out.sum().backward()
    assert not isinstance(w.grad, sparse.RowSparseNDArray)
    want = np.zeros((5, 2), np.float32)
    want[[0, 3]] = 2
    np.testing.assert_array_equal(w.grad.asnumpy(), want)


def test_autograd_grad_returns_row_sparse():
    w = nd.array(np.ones((6, 2), np.float32), ctx=CPU)
    w.attach_grad()
    with ag.record():
        out = nd.Embedding(nd.array([5, 0, 5], ctx=CPU), w, input_dim=6,
                           output_dim=2, sparse_grad=True)
    g = ag.grad(out.sum(), [w])[0]
    assert isinstance(g, sparse.RowSparseNDArray)
    assert g.indices.asnumpy().tolist() == [5, 0, 5]


def test_fused_fallback_sparse_grad(monkeypatch):
    """A row-sparse gradient routes the whole step through the loop
    (``sparse_grad``), whose lazy update touches its rows only; the
    compiled step falls back with the same label."""
    monkeypatch.setenv("MXNET_TPU_FUSED_UPDATE", "1")
    t, _ = _embeddings(20, 3)
    dense = gluon.nn.Dense(2, in_units=3, prefix="dense_")
    dense.initialize(device=CPU)
    params = dict(t.collect_params().items())
    params.update(dense.collect_params().items())
    tr = gluon.Trainer(params, "adam", {"learning_rate": 0.1})
    w0 = t.weight.data().detach().clone()
    with ag.record():
        loss = dense(t(nd.array(np.array([3, 3, 11]), ctx=CPU))).sum()
    loss.backward()
    tr.step(1)
    assert dict(tr._fused.fallbacks) == {"sparse_grad": 1}
    moved = (t.weight.data().detach() != w0).any(dim=1)
    assert moved.nonzero().reshape(-1).tolist() == [3, 11]
    step = tr.compile_step(lambda x: dense(t(x)).sum(axis=1))
    step(nd.array(np.array([1, 2]), ctx=CPU))
    assert step.last_reason == "sparse_grad"


def test_dense_adagrad_keeps_untouched_rows():
    """AdaGrad (no lazy form in the reference) reads a row-sparse
    gradient densely; with ``wd=0`` rows no lookup touched keep their
    bits, weight and history."""
    t, j = _embeddings(30, 2)
    w0 = t.weight.data().detach().clone()
    tr = gluon.Trainer(t.collect_params(), "adagrad", {"learning_rate": 0.1})
    jtr = jgluon.Trainer(j.collect_params(), "adagrad",
                         {"learning_rate": 0.1})
    _backward(t, j, np.array([4, 4, 17]))
    tr.step(1)
    jtr.step(1)
    w1 = t.weight.data().detach()
    rest = [i for i in range(30) if i not in (4, 17)]
    assert torch.equal(w1[rest], w0[rest])
    assert not tr._updaters[0].states[0][rest].any()
    np.testing.assert_allclose(w1.numpy(), j.weight.data().asnumpy(),
                               **LAZY_TOL)

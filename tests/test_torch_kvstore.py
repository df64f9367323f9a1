"""PyTorch port, the single-process kvstore (``mxnet_tpu_torch/kvstore``)
and the Trainer's kvstore arguments, against the JAX package on the same
numpy inputs, on the CPU.

Counterparts of tests/test_parallel.py's two local-store tests, of
tests/test_compression.py's six tests and of tests/test_sparse.py's
store test, then: ``gluon.Trainer(kvstore=, compression_params=,
update_on_kvstore=)`` (the reference's signature; before this port the
port's Trainer raised ``TypeError`` on them), ``update_on_kvstore``'s
assertions, the optimizer on the store, and the collective types
raising with ROADMAP.md §1 item 9 named.

Tolerances: the store's sums, pulls and the 2-bit codes, packed words
and residuals exact (bit for bit with the JAX package in f32); a
Trainer step against the reference's rtol 1e-6 / atol 1e-7 (one SGD
momentum update of the same gradients), and bit for bit between the
port's Trainer with a store and without one.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
import mxnet_tpu.autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.kvstore import compression as jgc
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.kvstore import compression as gc
from mxnet_tpu_torch.ndarray import sparse

torch.set_num_threads(2)
CPU = "cpu"
STEP_TOL = dict(rtol=1e-6, atol=1e-7)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


# ------------------------------------- tests/test_parallel.py:171-197 --
def test_kvstore_local_pushpull():
    kv = tmx.kv.create("local")
    kv.init(3, nd.ones((2, 3), ctx=CPU))
    kv.push(3, nd.ones((2, 3), ctx=CPU) * 8)
    out = nd.zeros((2, 3), ctx=CPU)
    kv.pull(3, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 3), 8.0))
    kv.push(3, [nd.ones((2, 3), ctx=CPU)] * 4)
    kv.pull(3, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 3), 4.0))
    # tensors are taken as they are, and pulled into in place
    t = torch.zeros(2, 3)
    kv.pushpull(3, [torch.ones(2, 3), torch.full((2, 3), 2.0)], out=t)
    assert torch.equal(t, torch.full((2, 3), 3.0))
    assert kv.type == "device" and kv.rank == 0 and kv.num_workers == 1


def test_kvstore_updater():
    results = []
    for mod, arr in ((tmx, lambda a: nd.array(a, ctx=CPU)),
                     (mx, mx.nd.array)):
        kv = mod.kv.create("device")
        kv.init("w", arr(np.zeros(4, np.float32)))

        def upd(key, grad, weight):
            weight -= 0.1 * grad
        kv.set_updater(upd)
        kv.push("w", arr(np.ones(4, np.float32)))
        out = arr(np.zeros(4, np.float32))
        kv.pull("w", out=out)
        results.append(out.asnumpy())
    np.testing.assert_array_equal(results[0], results[1])
    np.testing.assert_allclose(results[0], np.full(4, -0.1), rtol=1e-6)


# --------------------------------------------- tests/test_compression --
def test_pack_unpack_roundtrip():
    rs = np.random.RandomState(0)
    codes_np = rs.randint(0, 3, 1003).astype(np.uint8)
    comp, jcomp = gc.TwoBitCompression(0.5), jgc.TwoBitCompression(0.5)
    packed = comp.pack(torch.from_numpy(codes_np))
    assert packed.dtype == torch.int32 and packed.shape[0] == -(-1003 // 16)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(
        jcomp.pack(jnp.asarray(codes_np))))
    np.testing.assert_array_equal(comp.unpack(packed, 1003).numpy(),
                                  codes_np)


def test_quantizer_semantics_and_residual():
    g = np.array([2.5, 0.3, -0.9, -1.0, 1.0, 0.0], np.float32)
    deq, res = gc.TwoBitCompression(1.0).roundtrip(_t(g), torch.zeros(6))
    jdeq, jres = jgc.TwoBitCompression(1.0).roundtrip(jnp.asarray(g),
                                                      jnp.zeros(6))
    np.testing.assert_array_equal(deq.numpy(), [1, 0, 0, -1, 1, 0])
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    np.testing.assert_array_equal(res.numpy(), g - deq.numpy())


def test_error_feedback_is_unbiased_over_time():
    """200 pushes of one gradient carry its mass; every step's words and
    residual are the JAX package's bits."""
    comp, jcomp = gc.TwoBitCompression(0.5), jgc.TwoBitCompression(0.5)
    g_np = np.array([0.2, -0.07, 0.45, -0.3], np.float32)
    g, res, jres = _t(g_np), torch.zeros(4), jnp.zeros(4)
    total = np.zeros(4, np.float32)
    n = 200
    for _ in range(n):
        packed, res = comp.compress(g, res)
        jpacked, jres = jcomp.compress(jnp.asarray(g_np), jres)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
        np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
        total += comp.decompress(packed, (4,), torch.float32).numpy()
    np.testing.assert_allclose(total / n, g_np, atol=0.51 / n)


def test_create_validates_params():
    assert gc.create(None) is None
    assert gc.create({"type": "2bit", "threshold": 0.25}).threshold == 0.25
    with pytest.raises(ValueError):
        gc.create({"type": "1bit"})
    with pytest.raises(ValueError):
        gc.create({"type": "2bit", "bogus": 1})
    with pytest.raises(ValueError):
        gc.TwoBitCompression(0.0)


def test_kvstore_push_applies_compression_per_worker():
    """Each worker's slot quantizes through its own residual: two pushes
    of two values, pulled as the reference's store pulls them."""
    v1 = np.array([2.0, 0.4, -1.5, 0.0], np.float32)
    v2 = np.array([0.9, 1.1, -0.2, -3.0], np.float32)
    got = []
    for mod, arr in ((tmx, lambda a: nd.array(a, ctx=CPU)),
                     (mx, mx.nd.array)):
        kv = mod.kv.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": 1.0})
        assert kv.gradient_compression is not None
        kv.init(0, arr(np.zeros(4, np.float32)))
        for _ in range(2):
            kv.push(0, [arr(v1), arr(v2)])
            out = arr(np.zeros(4, np.float32))
            kv.pull(0, out=out)
            got.append(out.asnumpy())
    np.testing.assert_array_equal(got[0], [1, 1, -1, -1])
    np.testing.assert_array_equal(got[:2], got[2:])


def test_compressed_training_converges():
    comp = gc.TwoBitCompression(0.5)
    target = torch.tensor([1.0, -2.0, 0.5, 3.0])
    w, res = torch.zeros(4), torch.zeros(4)
    for _ in range(300):
        deq, res = comp.roundtrip(w - target, res)
        w = w - 0.2 * deq
    np.testing.assert_allclose(w.numpy(), target.numpy(), atol=0.05)


# ------------------------------------------ tests/test_sparse.py:219 --
def test_kvstore_row_sparse_pull_and_sparse_push():
    """A row-sparse pull into a row-sparse and into a dense ``out``; a
    sparse push that stays sparse; a sparse push through an optimizer on
    the store (SGD's lazy update there)."""
    val = np.arange(12, dtype=np.float32).reshape(6, 2)
    kv = tmx.kv.create("local")
    kv.init(3, nd.array(val, ctx=CPU))
    out = sparse.zeros("row_sparse", (6, 2), ctx=CPU)
    kv.row_sparse_pull(3, out=out, row_ids=nd.array([4, 1, 4], ctx=CPU))
    assert not out.densified and out.indices.asnumpy().tolist() == [1, 4]
    np.testing.assert_array_equal(out.data.asnumpy(), val[[1, 4]])
    dense = nd.array(np.full((6, 2), 9.0, np.float32), ctx=CPU)
    kv.row_sparse_pull(3, out=dense, row_ids=torch.tensor([5]))
    want = np.zeros((6, 2), np.float32)
    want[5] = val[5]
    np.testing.assert_array_equal(dense.asnumpy(), want)
    g1 = sparse.row_sparse_array((np.ones((1, 2), np.float32), [0]),
                                 shape=(6, 2), ctx=CPU)
    g2 = sparse.row_sparse_array((np.ones((1, 2), np.float32), [2]),
                                 shape=(6, 2), ctx=CPU)
    kv.init(4, sparse.zeros("row_sparse", (6, 2), ctx=CPU))
    kv.push(4, [g1, g2])
    assert isinstance(kv._store[4], sparse.RowSparseNDArray)
    assert kv._store[4].indices.asnumpy().tolist() == [0, 2]
    kv2 = tmx.kv.create("local")
    kv2.set_optimizer(tmx.optimizer.SGD(learning_rate=0.5))
    kv2.init(0, nd.array(val, ctx=CPU))
    kv2.push(0, [g1, g2])
    pulled = torch.zeros(6, 2)
    kv2.pull(0, out=pulled)
    want = val.copy()
    want[[0, 2]] -= 0.5
    np.testing.assert_array_equal(pulled.numpy(), want)


# -------------------------------------------------- the Trainer's args --
def _dense_pair(seed):
    """The port's and the reference's Dense(3, in_units=4), same weights,
    and one batch."""
    rs = np.random.RandomState(seed)
    w = rs.randn(3, 4).astype(np.float32)
    b = rs.randn(3).astype(np.float32)
    x = rs.randn(5, 4).astype(np.float32)
    t = gluon.nn.Dense(3, in_units=4, prefix="kvd_")
    t.initialize(device=CPU)
    t.weight.set_data(_t(w))
    t.bias.set_data(_t(b))
    j = jgluon.nn.Dense(3, in_units=4, prefix="jkvd_")
    j.initialize()
    j.weight.set_data(mx.nd.array(w))
    j.bias.set_data(mx.nd.array(b))
    return t, j, x


def _train(net, tr, x, jax=False):
    for _ in range(2):
        if jax:
            with jag.record():
                loss = (net(mx.nd.array(x)) ** 2).sum()
        else:
            with ag.record():
                loss = (net(nd.array(x, ctx=CPU)) ** 2).sum()
        loss.backward()
        tr.step(5)


@pytest.mark.parametrize("kvstore", [None, "device", "local", "",
                                     "nullkv", "instance"])
def test_trainer_takes_the_kvstore_arguments(kvstore):
    """The reference's arguments (a ``TypeError`` before this port); two
    steps equal the reference Trainer's from the same weights; with one
    device the store types update in place, a store instance pushes and
    pulls each gradient, and the step equals ``kvstore=None``'s bit for
    bit."""
    args = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})
    t, j, x = _dense_pair(1)
    kv = tmx.kv.create("local") if kvstore == "instance" else kvstore
    tr = gluon.Trainer(t.collect_params(), *args, kvstore=kv,
                       compression_params=None, update_on_kvstore=None)
    jkv = mx.kv.create("local") if kvstore == "instance" else kvstore
    jtr = jgluon.Trainer(j.collect_params(), *args, kvstore=jkv,
                         compression_params=None, update_on_kvstore=None)
    _train(t, tr, x)
    _train(j, jtr, x, jax=True)
    assert (tr._kvstore is None) == (jtr._kvstore is None) == \
        (kvstore != "instance")
    assert tr._update_on_kvstore is False
    for tp, jp in zip(sorted(t.collect_params().items()),
                      sorted(j.collect_params().items())):
        np.testing.assert_allclose(tp[1].data().detach().numpy(),
                                   jp[1].data().asnumpy(), **STEP_TOL)
    plain, _, _ = _dense_pair(1)
    _train(plain, gluon.Trainer(plain.collect_params(), *args,
                                kvstore=None), x)
    for a, b in zip(t.collect_params().values(),
                    plain.collect_params().values()):
        assert torch.equal(a.data(), b.data())


def test_compile_step_falls_back_with_a_store():
    """A store instance on the Trainer: its first compiled call makes the
    store and falls back with ``kvstore`` (the reference's label), and
    its step is the store's push and pull."""
    t, _, x = _dense_pair(3)
    tr = gluon.Trainer(t.collect_params(), "adam", {"learning_rate": 0.01},
                       kvstore=tmx.kv.create("local"))
    step = tr.compile_step(lambda a: (t(a) ** 2).sum(axis=1))
    step(nd.array(x, ctx=CPU))
    assert step.last_reason == "kvstore" and tr._kvstore is not None
    assert sorted(tr._kvstore._store) == [0, 1]


def test_update_on_kvstore_steps_on_the_store():
    """A store type other than local/device updates on the store (the
    optimizer set on it): the Trainer pulls the store's weights, equal to
    the in-place update; ``allreduce_grads`` and ``update`` assert as
    the reference's."""
    args = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})
    t, j, x = _dense_pair(2)
    tr = gluon.Trainer(t.collect_params(), *args, kvstore="nccl")
    jtr = jgluon.Trainer(j.collect_params(), *args, kvstore="nccl")
    _train(t, tr, x)
    _train(j, jtr, x, jax=True)
    assert tr._update_on_kvstore is True and jtr._update_on_kvstore is True
    for tp, jp in zip(sorted(t.collect_params().items()),
                      sorted(j.collect_params().items())):
        np.testing.assert_allclose(tp[1].data().detach().numpy(),
                                   jp[1].data().asnumpy(), **STEP_TOL)
    with pytest.raises(AssertionError, match="allreduce_grads\\(\\) when "
                       "parameters are updated on kvstore"):
        tr.allreduce_grads()
    with pytest.raises(AssertionError, match="update\\(\\) when parameters "
                       "are updated on kvstore"):
        tr.update(5)
    t2, _, _ = _dense_pair(2)
    tr2 = gluon.Trainer(t2.collect_params(), *args, kvstore="nccl",
                        update_on_kvstore=False)
    _train(t2, tr2, x)
    assert tr2._update_on_kvstore is False
    for a, b in zip(t.collect_params().values(),
                    t2.collect_params().values()):
        assert torch.equal(a.data(), b.data())


def test_store_optimizer_states_round_trip(tmp_path):
    kv = tmx.kv.create("local")
    with pytest.raises(AssertionError, match="updater is not set"):
        kv.save_optimizer_states(str(tmp_path / "none"))
    kv.set_optimizer(tmx.optimizer.Adam(learning_rate=0.01))
    kv.init(0, torch.ones(3))
    kv.push(0, torch.full((3,), 0.5))
    f = str(tmp_path / "kv.states")
    kv.save_optimizer_states(f)
    kv2 = tmx.kv.create("local")
    kv2.set_optimizer(tmx.optimizer.Adam(learning_rate=0.01))
    kv2.load_optimizer_states(f)
    for a, b in zip(kv._updater.states[0], kv2._updater.states[0]):
        assert np.array_equal(np.asarray(b), a.numpy())
    assert kv.is_capable("optimizer") and kv.fused_reduce_compatible is False


@pytest.mark.parametrize("name", ["dist_sync", "dist_async", "tpu",
                                  "horovod"])
def test_collective_types_name_their_roadmap_item(name):
    with pytest.raises(NotImplementedError, match="§1 item 9"):
        tmx.kv.create(name)
    with pytest.raises(ValueError, match="unknown KVStore"):
        tmx.kv.create("no_such_store")


def test_registered_backend_is_created_by_name():
    @tmx.kv.KVStoreBase.register
    class MyStore(tmx.kv.KVStoreLocal):
        pass
    assert isinstance(tmx.kv.create("mystore"), MyStore)
    assert tmx.kvstore.KVStore is tmx.kv.KVStore

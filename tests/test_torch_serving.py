"""PyTorch port, single-shot serving: ``mxnet_tpu_torch.serving``'s
bucketing, ``MicroBatchQueue``, ``ModelServer`` and ``Block.serve``
against the JAX package's (the port of ``tests/test_serving.py``), on
the CPU.

The model is the reference test's ``HybridSequential(Dense(16, tanh),
Dense(4))`` over items of 8 floats, the JAX net's weights carried into
the port's by ``convert.load_gluon_params``. What is held:

- the bucket math (``bucket_sizes``, ``pick_bucket``, ``pad_to_bucket``,
  ``pad_batch``, ``waste_fraction``, ``BucketSpec``) equals the
  reference's on the same inputs, exactly, errors included;
- the port's ``ModelServer`` over the port's block answers the same
  numpy requests as the JAX ``ModelServer`` over the reference net, at
  rtol 1e-5 / atol 1e-6 (the reference test's tolerance for a block
  served directly: the same f32 matmuls and tanh, sums in another
  order);
- batching is invisible: a sample served in a micro-batch is
  bit-identical to the same sample run alone through the same bucket's
  forward;
- nothing is built or captured after ``warmup()`` (the CPU captures
  nothing at all), drains resolve every Future, stats match the load,
  the env-var config resolves as the reference's, ``stats()`` has the
  reference's keys;
- the server serves its own snapshot of the weights: a ``Trainer.step``
  on the block after the server is built leaves the served outputs as
  they were (the reference's ``extract_params`` snapshot).
"""
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.autograd as jag  # noqa: E402
from mxnet_tpu import nd, serving as jserving  # noqa: E402
from mxnet_tpu.gluon import nn as jnn  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu_torch import autograd as tag  # noqa: E402
from mxnet_tpu_torch import serving  # noqa: E402
from mxnet_tpu_torch.convert import load_gluon_params  # noqa: E402
from mxnet_tpu_torch.gluon import Trainer, loss as tloss  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tnn  # noqa: E402
from mxnet_tpu_torch.resilience import PreemptionGuard  # noqa: E402

torch.set_num_threads(2)

ITEM = (8,)
RTOL, ATOL = 1e-5, 1e-6


def _jnet():
    mx.random.seed(7)
    net = jnn.HybridSequential()
    with net.name_scope():
        net.add(jnn.Dense(16, activation="tanh"), jnn.Dense(4))
    net.initialize()
    with jag.pause():
        net(nd.array(np.zeros((1,) + ITEM, np.float32)))
    return net


def _tnet(arrays):
    net = tnn.HybridSequential()
    with net.name_scope():
        net.add(tnn.Dense(16, activation="tanh"), tnn.Dense(4))
    net.initialize(device="cpu")
    load_gluon_params(net, arrays)
    return net


@pytest.fixture(scope="module")
def nets():
    """(JAX net, the JAX net's weights by name): every test builds its
    own port block from the weights (a trainer may change a block)."""
    jnet = _jnet()
    arrays = {k: v.data().asnumpy()
              for k, v in jnet.collect_params().items()}
    return jnet, arrays


@pytest.fixture
def net(nets):
    return _tnet(nets[1])


def _server(net, **kw):
    kw.setdefault("item_shape", ITEM)
    kw.setdefault("dtype", "float32")
    return serving.ModelServer(net, **kw)


def _forward(net, rows):
    with tag.pause():
        return net(torch.from_numpy(rows)).numpy()


# ------------------------------------------------------- bucket math --
BUCKET_CASES = [(1, 1), (2, 1), (6, 1), (8, 1), (8, 4), (12, 3), (16, 16),
                (0, 1), (4, 5), (4, 0)]


def _outcome(fn, *args, **kw):
    try:
        out = fn(*args, **kw)
    except ValueError as exc:
        return ("ValueError", str(exc))
    return out


@pytest.mark.parametrize("max_batch,min_bucket", BUCKET_CASES)
def test_bucket_sizes_equal_reference(max_batch, min_bucket):
    assert _outcome(serving.bucket_sizes, max_batch, min_bucket) == \
        _outcome(jserving.bucket_sizes, max_batch, min_bucket)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 9])
def test_pick_bucket_and_padding_equal_reference(n):
    buckets = [1, 2, 4, 8]
    assert _outcome(serving.pick_bucket, n, buckets) == \
        _outcome(jserving.pick_bucket, n, buckets)
    rows = np.random.RandomState(n).randn(max(n, 1), 3, 5) \
        .astype(np.float32)
    for axis in (0, 1):
        for bucket in (rows.shape[axis], 8):
            ours = _outcome(serving.pad_to_bucket, rows, bucket, axis)
            theirs = _outcome(jserving.pad_to_bucket, rows, bucket, axis)
            if isinstance(theirs, tuple):
                assert ours == theirs
            else:
                assert ours.dtype == theirs.dtype
                np.testing.assert_array_equal(ours, theirs)
                assert (ours is rows) == (theirs is rows)
    padded = serving.pad_batch(rows, 8) if n <= 8 else None
    if padded is not None:
        np.testing.assert_array_equal(padded,
                                      jserving.pad_batch(rows, 8))
    if 1 <= n <= 8:
        b = serving.pick_bucket(n, buckets)
        assert serving.waste_fraction(n, b) == \
            jserving.waste_fraction(n, b)


@pytest.mark.parametrize("max_size,min_bucket,multiple_of", [
    (8, 1, 1), (16, 2, 1), (64, 1, 16), (48, 1, 16), (10, 1, 4)])
def test_bucket_spec_equals_reference(max_size, min_bucket, multiple_of):
    from mxnet_tpu.serving.bucketing import BucketSpec as JSpec
    from mxnet_tpu_torch.serving.bucketing import BucketSpec as TSpec
    def make(spec):
        return spec.pow2(max_size, min_bucket=min_bucket, axis=1,
                         multiple_of=multiple_of)
    ours, theirs = _outcome(make, TSpec), _outcome(make, JSpec)
    if isinstance(theirs, tuple):
        assert ours == theirs
        return
    assert ours.buckets == theirs.buckets and ours.axis == theirs.axis
    assert ours.max_size == theirs.max_size and len(ours) == len(theirs)
    assert list(ours) == list(theirs)
    assert ours.warmup_shapes((3, 5)) == theirs.warmup_shapes((3, 5))
    rows = np.ones((2, 3, 4), np.float32)
    for n in (1, 3, max_size):
        assert ours.waste(n) == theirs.waste(n)
        assert ours.pick(n) == theirs.pick(n)
        got, b1 = ours.pad(rows[:, :1].repeat(n, axis=1))
        want, b2 = theirs.pad(rows[:, :1].repeat(n, axis=1))
        assert b1 == b2
        np.testing.assert_array_equal(got, want)
    assert repr(ours) == repr(theirs)


def test_bucket_spec_rejects_what_the_reference_rejects():
    from mxnet_tpu.serving.bucketing import BucketSpec as JSpec
    from mxnet_tpu_torch.serving.bucketing import BucketSpec as TSpec
    for args in ([], [0, 2], [-1]):
        with pytest.raises(ValueError):
            JSpec(args)
        with pytest.raises(ValueError):
            TSpec(args)
    assert TSpec([4, 1, 2, 2]).buckets == JSpec([4, 1, 2, 2]).buckets


# ------------------------------------------------- batching queue ----
def test_queue_coalesces_up_to_max_batch():
    q = serving.MicroBatchQueue()
    for i in range(5):
        q.submit(i)
    batch = q.get_batch(max_batch=4, max_delay_s=0.001)
    assert [r.x for r in batch] == [0, 1, 2, 3]
    batch = q.get_batch(max_batch=4, max_delay_s=0.001)
    assert [r.x for r in batch] == [4]
    assert all(r.wait_s >= 0.0 for r in batch)


def test_queue_waits_at_most_max_delay():
    q = serving.MicroBatchQueue()
    q.submit("only")
    t0 = time.monotonic()
    batch = q.get_batch(max_batch=8, max_delay_s=0.05)
    took = time.monotonic() - t0
    assert len(batch) == 1 and took < 2.0


def test_queue_close_rejects_and_signals_empty():
    q = serving.MicroBatchQueue()
    q.submit(1)
    q.close()
    with pytest.raises(serving.ServerClosed):
        q.submit(2)
    assert [r.x for r in q.get_batch(4, 0.001)] == [1]
    assert q.get_batch(4, 0.001) == []


def test_queue_bounded_depth_sheds_and_drains():
    q = serving.MicroBatchQueue(max_depth=2)
    reqs = [q.submit_request(i) for i in range(2)]
    with pytest.raises(serving.Overloaded) as ei:
        q.submit(3)
    assert ei.value.reason == "queue_full" and ei.value.depth == 2
    assert q.drain() == reqs and q.depth() == 0
    assert reqs[0].rid < reqs[1].rid


# ------------------------------------------------ (a) exactness ------
def test_port_server_matches_jax_server(nets, net):
    """The same requests through the JAX ModelServer over the reference
    net and the port's over the port's net (same weights)."""
    jnet, _ = nets
    X = np.random.RandomState(0).randn(10, *ITEM).astype(np.float32)
    outs = {}
    for tag_, srv in (("jax", jserving.ModelServer(
            jnet, buckets=[1, 2, 4], max_delay_ms=5.0, item_shape=ITEM,
            dtype="float32", name="jax_match")),
            ("torch", _server(net, buckets=[1, 2, 4], max_delay_ms=5.0,
                              name="torch_match"))):
        srv.start()
        srv.warmup()
        outs[tag_] = [f.result(timeout=60)
                      for f in [srv.submit(r) for r in X]]
        srv.shutdown()
    for a, b in zip(outs["torch"], outs["jax"]):
        assert a.shape == b.shape == (4,)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_batched_bit_identical_to_unbatched(net):
    """Requests coalesced into micro-batches are bit-identical to the
    same sample run alone through the same bucket's forward."""
    B = 4
    srv = _server(net, buckets=[B], max_delay_ms=5.0)
    srv.start()
    srv.warmup()
    X = np.random.RandomState(0).randn(10, *ITEM).astype(np.float32)
    futs = [srv.submit(r) for r in X]
    got = [f.result(timeout=60) for f in futs]
    for r, g in zip(X, got):
        ref = srv._fn(serving.pad_batch(r[None], B))[0]
        np.testing.assert_array_equal(g, ref)
    srv.shutdown()


def test_same_inputs_same_outputs_any_batching(net):
    srv = _server(net, buckets=[1, 2, 4], max_delay_ms=2.0).start()
    srv.warmup()
    x = np.random.RandomState(1).randn(*ITEM).astype(np.float32)
    futs = [srv.submit(x) for _ in range(17)]
    outs = [f.result(timeout=60) for f in futs]
    srv.shutdown()
    assert srv.stats()["batches"] >= 1
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0], o, rtol=1e-5, atol=1e-7)


# ---------------------------------------- (b) zero recompiles --------
def test_zero_compiles_after_warmup_ragged_load(net):
    srv = _server(net, buckets=[1, 2, 4], max_delay_ms=1.0).start()
    srv.warmup()
    X = np.random.RandomState(2).randn(40, *ITEM).astype(np.float32)
    before = srv.programs()
    with serving.CompileCounter() as cc:
        i = 0
        while i < len(X):
            burst = (i % 6) + 1
            futs = [srv.submit(r) for r in X[i:i + burst]]
            for f in futs:
                f.result(timeout=60)
            i += burst
    srv.shutdown()
    assert cc.count == 0
    st = srv.stats()
    assert sum(st["bucket_hits"].values()) == st["batches"]
    progs = srv.programs()
    # the CPU captures nothing; each batch is one run of the forward
    assert progs["graphs"] == 0 and progs["replays"] == 0
    assert progs["dispatches"] - before["dispatches"] == st["batches"]
    assert progs["buckets"] == [1, 2, 4]


def test_warmup_compiles_nothing_on_the_cpu(net):
    srv = _server(net, buckets=[1, 2, 4], max_delay_ms=1.0).start()
    with serving.CompileCounter() as cc:
        timings = srv.warmup()
        srv.warmup()
    srv.shutdown()
    assert cc.count == 0
    assert sorted(timings) == [1, 2, 4]
    assert srv.graph_pool_bytes() == 0


# ------------------------------------------------- (c) drain ---------
def test_shutdown_drains_every_inflight_request(net):
    srv = _server(net, buckets=[1, 2, 4], max_delay_ms=200.0).start()
    srv.warmup()
    X = np.random.RandomState(3).randn(9, *ITEM).astype(np.float32)
    futs = [srv.submit(r) for r in X]
    srv.shutdown(drain=True)
    outs = [f.result(timeout=60) for f in futs]
    assert len(outs) == len(X)
    for r, g in zip(X, outs):
        np.testing.assert_allclose(g, _forward(net, r[None])[0],
                                   rtol=RTOL, atol=ATOL)
    with pytest.raises(serving.ServerClosed):
        srv.submit(X[0])


def test_preemption_guard_drain(net):
    guard = PreemptionGuard(signals=(signal.SIGUSR1,)).install()
    try:
        srv = _server(net, buckets=[1, 2, 4], max_delay_ms=200.0).start()
        srv.warmup()
        srv.attach_preemption_guard(guard, poll_s=0.01)
        X = np.random.RandomState(4).randn(7, *ITEM).astype(np.float32)
        futs = [srv.submit(r) for r in X]
        os.kill(os.getpid(), signal.SIGUSR1)
        outs = [f.result(timeout=60) for f in futs]
        assert len(outs) == len(X)
        deadline = time.monotonic() + 10
        while srv.running and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(serving.ServerClosed):
            srv.submit(X[0])
    finally:
        guard.uninstall()


def test_shutdown_without_drain_fails_queued(net):
    srv = _server(net, buckets=[4], max_delay_ms=500.0).start()
    srv.warmup()
    fut = srv.submit(np.zeros(ITEM, np.float32))
    srv.shutdown(drain=False)
    with pytest.raises(serving.ServerClosed):
        fut.result(timeout=60)


# ------------------------------------------------- (d) stats ---------
def test_stats_consistent_with_load(net, tmp_path):
    log_path = str(tmp_path / "events.jsonl")
    srv = _server(net, buckets=[1, 2, 4], max_delay_ms=1.0,
                  event_log=log_path)
    srv.start()
    srv.warmup()
    N = 30
    X = np.random.RandomState(5).randn(N, *ITEM).astype(np.float32)
    errs = []

    def client(rows):
        try:
            for r in rows:
                srv.predict(r, timeout=60)
        except Exception as exc:             # pragma: no cover
            errs.append(exc)

    threads = [threading.Thread(target=client, args=(X[i::3],))
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errs
    srv.shutdown()
    st = srv.stats()
    assert st["requests_submitted"] == N
    assert st["requests_completed"] == N
    assert st["requests_failed"] == 0
    assert sum(st["bucket_hits"].values()) == st["batches"]
    assert 1 <= st["batches"] <= N
    assert 0.0 <= st["padded_waste"] < 1.0
    assert st["latency_ms"]["p50"] <= st["latency_ms"]["p95"] \
        <= st["latency_ms"]["p99"]
    assert st["throughput_rps"] > 0
    with open(log_path) as f:
        events = [json.loads(line) for line in f]
    kinds = {e["event"] for e in events}
    assert {"start", "warmup", "batch", "stop"} <= kinds
    assert sum(e["n"] for e in events if e["event"] == "batch") == N


def test_stats_keys_equal_reference(nets, net):
    """``stats()`` and ``debug_status()`` report the reference's keys."""
    jnet, _ = nets
    x = np.zeros(ITEM, np.float32)
    snaps = {}
    for tag_, srv in (("jax", jserving.ModelServer(
            jnet, buckets=[1, 2], item_shape=ITEM, dtype="float32",
            name="jax_keys")),
            ("torch", _server(net, buckets=[1, 2], name="torch_keys"))):
        srv.start()
        srv.predict(x, timeout=60, tenant="acme")
        snaps[tag_] = (srv.stats(), srv.debug_status())
        srv.shutdown()
    (js, jd), (ts, td) = snaps["jax"], snaps["torch"]
    assert set(ts) == set(js)
    for k in ("wait_ms", "latency_ms", "service_ms"):
        assert set(ts[k]) == set(js[k])
    assert set(td) == set(jd)
    for k in ("requests_submitted", "requests_completed", "batches",
              "bucket_hits", "buckets", "tenants", "shed"):
        assert ts[k] == js[k], k
    assert ts["compiles"] >= 0 and ts["buckets"] == [1, 2]


# ------------------------------------------------- backends ----------
def test_serve_directly_from_hybrid_block(nets):
    """``Block.serve`` resolves deferred shapes from the example and
    serves the block's forward; held against the JAX block's too."""
    jnet, arrays = nets
    net = tnn.HybridSequential()
    with net.name_scope():
        net.add(tnn.Dense(16, activation="tanh"), tnn.Dense(4))
    net.initialize(device="cpu")
    x = np.random.RandomState(6).randn(*ITEM).astype(np.float32)
    with net.serve(example_input=x, buckets=[1, 2, 4],
                   max_delay_ms=1.0) as srv:
        assert srv._item_shape == ITEM and srv._dtype == np.float32
        srv.warmup()
        np.testing.assert_allclose(srv.predict(x, timeout=60),
                                   _forward(net, x[None])[0],
                                   rtol=RTOL, atol=ATOL)
    load_gluon_params(net, arrays)
    with net.serve(example_input=torch.from_numpy(x), buckets=[1]) as srv:
        with jag.pause():
            want = jnet(nd.array(x[None])).asnumpy()[0]
        np.testing.assert_allclose(srv.predict(x, timeout=60), want,
                                   rtol=RTOL, atol=ATOL)


def test_served_weights_are_a_snapshot(net):
    """A ``Trainer.step`` on the block after the server is built does
    not change what the server serves (the reference snapshots the
    parameters when it builds the server; JAX arrays never change)."""
    x = np.random.RandomState(8).randn(*ITEM).astype(np.float32)
    want = _forward(net, x[None])[0]
    srv = _server(net, buckets=[1, 2], max_delay_ms=1.0).start()
    srv.warmup()
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.5})
    loss = tloss.L2Loss()
    with tag.record():
        out = loss(net(torch.from_numpy(x[None])), torch.ones(1, 4))
    out.backward(torch.ones_like(out))
    trainer.step(1)
    trained = _forward(net, x[None])[0]
    assert np.abs(trained - want).max() > 1e-3      # the block moved
    np.testing.assert_array_equal(srv.predict(x, timeout=60), want)
    fresh = _server(net, buckets=[1], name="fresh").start()
    np.testing.assert_array_equal(fresh.predict(x, timeout=60), trained)
    fresh.shutdown()
    srv.shutdown()


def test_l2loss_equals_reference():
    rng = np.random.RandomState(9)
    pred = rng.randn(4, 3, 2).astype(np.float32)
    label = rng.randn(4, 6).astype(np.float32)
    sw = rng.rand(4, 3, 2).astype(np.float32)
    from mxnet_tpu.gluon import loss as jloss
    for kw, args in (({}, ()), ({"weight": 3.0, "batch_axis": 1}, ()),
                     ({}, (sw,))):
        with jag.pause():
            want = jloss.L2Loss(**kw)(nd.array(pred), nd.array(label),
                                      *[nd.array(a) for a in args])
        got = tloss.L2Loss(**kw)(torch.from_numpy(pred),
                                 torch.from_numpy(label),
                                 *[torch.from_numpy(a) for a in args])
        np.testing.assert_allclose(got.numpy(), want.asnumpy(),
                                   rtol=1e-6, atol=1e-7)


def test_predictor_artifact_raises_type_error():
    class Predictor:            # a deploy.Predictor's shape
        poly_batch = True
        input_shape = (1, 8)

        def predict(self, batch):
            return batch
    with pytest.raises(TypeError, match="item 14"):
        serving.ModelServer(Predictor(), buckets=[1])
    with pytest.raises(TypeError):
        serving.ModelServer(object(), buckets=[1])


def test_block_returning_a_tuple_is_refused():
    class Two(tnn.HybridSequential):
        def forward(self, x):
            return x, x
    blk = Two()
    srv = serving.ModelServer(blk, buckets=[1], item_shape=ITEM,
                              dtype="float32").start()
    with pytest.raises(TypeError, match="one tensor"):
        srv.predict(np.zeros(ITEM, np.float32), timeout=60)
    srv.shutdown()


def test_request_shape_validation(net):
    srv = _server(net, buckets=[1]).start()
    with pytest.raises(ValueError):
        srv.submit(np.zeros((2,) + ITEM, np.float32))
    srv.shutdown()


def test_env_var_config(net, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_SERVE_MAX_BATCH", "16")
    monkeypatch.setenv("MXNET_TPU_SERVE_MAX_DELAY_MS", "7.5")
    srv = serving.ModelServer(net)
    assert srv.max_batch_size == 16
    assert srv.buckets == [1, 2, 4, 8, 16]
    assert srv.max_delay_s == pytest.approx(0.0075)
    monkeypatch.setenv("MXNET_TPU_SERVE_BUCKETS", "2,8")
    srv2 = serving.ModelServer(net)
    assert srv2.buckets == [2, 8]
    assert srv2.max_batch_size == 8
    with pytest.raises(ValueError):
        serving.ModelServer(net, buckets=[1, 2], max_batch_size=4)


def test_overload_env_var_config(net, monkeypatch):
    srv = serving.ModelServer(net, buckets=[1])
    assert srv.max_queue is None
    assert srv.default_deadline_ms is None
    monkeypatch.setenv("MXNET_TPU_SERVE_MAX_QUEUE", "32")
    monkeypatch.setenv("MXNET_TPU_SERVE_DEADLINE_MS", "250")
    srv2 = serving.ModelServer(net, buckets=[1])
    assert srv2.max_queue == 32
    assert srv2._queue.max_depth == 32
    assert srv2.default_deadline_ms == 250.0
    srv3 = serving.ModelServer(net, buckets=[1], max_queue=4,
                               deadline_ms=50)
    assert srv3.max_queue == 4 and srv3.default_deadline_ms == 50.0


def test_typed_errors_exported_under_one_base(net):
    srv = _server(net, buckets=[1]).start()
    srv.shutdown()
    with pytest.raises(serving.ServingError):
        srv.submit(np.zeros(ITEM, np.float32))
    with pytest.raises(RuntimeError):
        srv.submit(np.zeros(ITEM, np.float32))

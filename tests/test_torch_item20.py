"""PyTorch port, the members and names the port lacked (ROADMAP §3 item
20), each held to the JAX package's:

- ``Parameter.data(ctx)`` / ``grad(ctx)`` take a Context (one the data
  does not live on raises, as the reference's ``_check_initialized``);
  ``Parameter.list_ctx()`` and ``ParameterDict.list_ctx()`` return
  Contexts (``[cpu(0)]``), and ``data(ctx)`` over ``list_ctx()`` runs as
  ``tests/test_checkpoint_sharded.py`` calls it;
- ``HybridBlock.export`` writes ``path-0000.params`` keyed ``arg:`` /
  ``aux:`` (no graph JSON), which the JAX package's ``nd.load`` reads
  with the JAX export's keys and bits; ``optimize_for`` hybridizes and
  runs;
- the names ``gluon.CachedOp``, ``gluon.SymbolBlock``, ``nd.Context``,
  ``nd.current_context``, ``mx.contrib.quantization``,
  ``Initializer.set_verbosity``, ``PagedKVCache.table_row``,
  ``error.NotImplementedForSymbol``, ``callback.do_checkpoint``;
- ``params=`` on ``MultiHeadAttention``, ``BERTEncoderLayer``,
  ``BERTEncoder`` and ``BERTModel`` (2 layers, 64 units): the blocks
  share the parameters the JAX blocks share (the same ``data_ptr()``),
  and the sharing block computes the JAX one's output (f32, rtol 1e-5,
  atol 1e-6 with the weights carried across);
- ``CompiledTrainStep.cost_analysis()`` is None before the first step,
  then within 10% of the JAX step's XLA ``flops`` for a Dense MLP (the
  port counts matrix products only; XLA also counts the elementwise
  work, ~2% here).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import gluon as jgluon, nd as jnd  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch.convert import load_gluon_params  # noqa: E402

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _jparams(block):
    return {k: v.data().asnumpy() for k, v in
            block.collect_params().items()}


def _dense_bn(pkg, prefix):
    g = jgluon if pkg == "jax" else tgluon
    net = g.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(g.nn.Dense(4, in_units=3), g.nn.BatchNorm(in_channels=4))
    if pkg == "jax":
        net.initialize()
    else:
        net.initialize(ctx="cpu")
    return net


# ------------------------------------------------------------- contexts ---
def test_parameter_data_and_grad_take_a_context():
    jnet, tnet = _dense_bn("jax", "ctx_"), _dense_bn("torch", "ctx_")
    jw, tw = jnet[0].weight, tnet[0].weight
    assert repr(tw.list_ctx()) == repr(jw.list_ctx()) == "[cpu(0)]"
    assert tw.list_ctx() == [tmx.cpu()]
    assert repr(tnet.collect_params().list_ctx()) == \
        repr(jnet.collect_params().list_ctx()) == "[cpu(0)]"
    assert tw.data(tmx.cpu()) is tw.data()
    assert tw.grad(tmx.cpu()) is tw.grad()
    assert tw.data("cpu") is tw.data()
    jw.data(jmx.cpu())
    with pytest.raises(RuntimeError, match="was not initialized on context"):
        tw.data(tmx.gpu(0))
    with pytest.raises(RuntimeError, match="was not initialized on context"):
        tw.grad(tmx.gpu(0))
    with pytest.raises(RuntimeError, match="was not initialized on context"):
        jw.data(jmx.tpu(3))
    # the call of tests/test_checkpoint_sharded.py
    load_gluon_params(tnet, _jparams(jnet))
    for tp, jp in zip(tnet.collect_params().values(),
                      jnet.collect_params().values()):
        for ctx in tp.list_ctx():
            assert np.array_equal(tp.data(ctx).detach().numpy(),
                                  jp.data().asnumpy())


# --------------------------------------------------------------- export ---
def test_export_writes_what_the_jax_export_writes(tmp_path):
    jnet, tnet = _dense_bn("jax", "exp_"), _dense_bn("torch", "exp_")
    load_gluon_params(tnet, _jparams(jnet))
    jfile = jnet.export(str(tmp_path / "j"))
    tfile = tnet.export(str(tmp_path / "t"), epoch=0)
    assert tfile == str(tmp_path / "t-0000.params")
    assert sorted(os.listdir(tmp_path)) == ["j-0000.params",
                                            "t-0000.params"]
    got, want = jnd.load(tfile), jnd.load(jfile)
    assert sorted(got) == sorted(want)
    assert {k.split(":")[0] for k in got} == {"arg", "aux"}
    for k in want:
        assert np.array_equal(got[k].asnumpy(), want[k].asnumpy()), k


def test_optimize_for_hybridizes_and_runs():
    jnet, tnet = _dense_bn("jax", "opt_"), _dense_bn("torch", "opt_")
    load_gluon_params(tnet, _jparams(jnet))
    x = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    got = tnet.optimize_for(torch.from_numpy(x), backend="anything")
    want = jnet.optimize_for(jnd.array(x), backend="anything")
    assert tnet._active and jnet._active
    np.testing.assert_allclose(got.detach().numpy(), want.asnumpy(),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- names ---
NAMES = {
    "gluon.CachedOp": lambda m: m.gluon.CachedOp,
    "gluon.SymbolBlock": lambda m: m.gluon.SymbolBlock,
    "nd.Context": lambda m: m.nd.Context,
    "nd.current_context": lambda m: m.nd.current_context,
    "contrib.quantization": lambda m: m.contrib.quantization,
    "error.NotImplementedForSymbol":
        lambda m: m.error.NotImplementedForSymbol,
    "callback.do_checkpoint": lambda m: m.callback.do_checkpoint,
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_names_resolve_in_both_packages(name):
    assert NAMES[name](jmx) is not None
    assert NAMES[name](tmx) is not None
    if name.startswith("nd."):
        assert NAMES[name](tmx) is getattr(tmx, name.split(".")[1])
    if name == "error.NotImplementedForSymbol":
        assert issubclass(tmx.error.NotImplementedForSymbol, tmx.MXNetError)
        assert "NotImplementedForSymbol" in tmx.error._ERROR_REGISTRY


def test_contrib_quantization_is_an_attribute():
    import mxnet_tpu_torch.contrib as tcontrib
    assert tcontrib.quantization.optimal_threshold is not None


def test_initializer_set_verbosity():
    for init_mod in (jmx.initializer, tmx.initializer):
        init = init_mod.Xavier()
        printed = []
        assert init.set_verbosity(True, printed.append) is init
        assert init._verbose is True
        assert init.set_verbosity() is init and init._verbose is False


def test_paged_kv_cache_table_row():
    from mxnet_tpu.serving.llm.kv_cache import PagedKVCache as J
    from mxnet_tpu_torch.serving.llm.kv_cache import PagedKVCache as T
    kw = dict(num_layers=1, num_heads=2, head_dim=8, block_size=4,
              num_blocks=16, max_context=20)
    j, t = J(**kw), T(device="cpu", **kw)
    for ids in ([], [3], [1, 2, 7, 9, 11]):
        got, want = t.table_row(ids), j.table_row(ids)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)
    from mxnet_tpu_torch.serving.llm.kv_cache import KVCacheError
    with pytest.raises(KVCacheError, match="block table"):
        t.table_row(list(range(1, 7)))


# ------------------------------------------------------------- sharing ---
BERT = dict(units=64, hidden_size=128, num_heads=2)


def _blocks(pkg, kind):
    if pkg == "jax":
        from mxnet_tpu.gluon.model_zoo import bert
        from mxnet_tpu.gluon.nn.attention import MultiHeadAttention
    else:
        from mxnet_tpu_torch.gluon.model_zoo import bert
        from mxnet_tpu_torch.gluon.nn.attention import MultiHeadAttention
    u, h, n = BERT["units"], BERT["hidden_size"], BERT["num_heads"]
    make = {
        "MultiHeadAttention": lambda **kw: MultiHeadAttention(
            u, n, flash=False, **kw),
        "BERTEncoderLayer": lambda **kw: bert.BERTEncoderLayer(
            u, h, n, dropout=0.0, flash=False, **kw),
        "BERTEncoder": lambda **kw: bert.BERTEncoder(
            2, u, h, n, dropout=0.0, flash=False, **kw),
        "BERTModel": lambda **kw: bert.BERTModel(
            vocab_size=50, num_layers=2, max_length=16, dropout=0.0,
            flash=False, **BERT, **kw),
    }[kind]
    prefix = f"sh{kind.lower()}_"
    a = make(prefix=prefix)
    b = make(prefix=prefix, params=a.collect_params())
    for blk in (a, b):
        if pkg == "jax":
            blk.initialize()
        else:
            blk.initialize(ctx="cpu")
    return a, b


def _run(pkg, blk, kind, x):
    if kind == "BERTModel":
        arr = jnd.array(x) if pkg == "jax" else torch.from_numpy(x)
        out = blk(arr, None, None)[0]
    else:
        arr = jnd.array(x) if pkg == "jax" else torch.from_numpy(x)
        out = blk(arr)
    return out.asnumpy() if pkg == "jax" else out.detach().numpy()


@pytest.mark.parametrize("kind", ["MultiHeadAttention", "BERTEncoderLayer",
                                  "BERTEncoder", "BERTModel"])
def test_params_sharing_matches_the_reference(kind):
    ja, jb = _blocks("jax", kind)
    ta, tb = _blocks("torch", kind)

    def shared(a, b):
        pa, pb = a.collect_params(), b.collect_params()
        return sorted(k for k in pa.keys() if k in pb.keys()
                      and pa[k] is pb[k])
    assert shared(ta, tb) == shared(ja, jb)
    rs = np.random.RandomState(3)
    x = (rs.randint(0, 50, (2, 8)).astype(np.float32)
         if kind == "BERTModel" else
         rs.randn(2, 8, BERT["units"]).astype(np.float32))
    # the first calls resolve the deferred shapes
    _run("jax", ja, kind, x)
    want = _run("jax", jb, kind, x)
    load_gluon_params(ta, _jparams(ja))
    load_gluon_params(tb, _jparams(jb))
    pa, pb = ta.collect_params(), tb.collect_params()
    for k in shared(ta, tb):
        assert pa[k].data().data_ptr() == pb[k].data().data_ptr()
    np.testing.assert_allclose(_run("torch", tb, kind, x), want,
                               rtol=RTOL, atol=1e-5)


# -------------------------------------------------------- cost analysis ---
def _mlp(g, prefix):
    net = g.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(g.nn.Dense(256, activation="relu", in_units=256),
                g.nn.Dense(256, activation="relu", in_units=256),
                g.nn.Dense(10, in_units=256))
    return net


def test_compiled_step_cost_analysis_counts_the_reference_flops():
    rs = np.random.RandomState(0)
    x = rs.randn(64, 256).astype(np.float32)
    y = (np.arange(64) % 10).astype(np.float32)
    jnet = _mlp(jgluon, "cost_")
    jnet.initialize()
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd",
                         {"learning_rate": 0.1})
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
    jstep = jtr.compile_step(lambda a, b: jloss(jnet(a), b))
    jstep(jnd.array(x), jnd.array(y))
    want = jstep.cost_analysis()["flops"]
    tnet = _mlp(tgluon, "cost_")
    tnet.initialize(ctx="cpu")
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd",
                         {"learning_rate": 0.1})
    tloss = tgluon.loss.SoftmaxCrossEntropyLoss()
    tstep = ttr.compile_step(lambda a, b: tloss(tnet(a), b))
    assert tstep.cost_analysis() is None and tstep.last_cost_analysis is None
    tstep(torch.from_numpy(x), torch.from_numpy(y))
    got = tstep.cost_analysis()["flops"]
    assert tstep.last_cost_analysis == {"flops": got}
    assert abs(got - want) <= 0.1 * want, (got, want)

"""PyTorch port, the Module API (``mxnet_tpu_torch/module``, ``model.py``,
``visualization.py``, ``gluon.SymbolBlock``) against the JAX package run
on the same data, the same initial parameters carried across with
``convert.arg_aux_from_numpy``:

- ``Module.fit`` of ``examples/train_mnist_mlp.py``'s net, 2 epochs of
  SGD with momentum over a shuffled ``NDArrayIter`` (both shuffle from
  numpy's global generator): the parameters after ``fit`` within rtol
  1e-4 / atol 1e-5 (16 steps of f32 updates through three products, the
  sums in another order), ``score`` and ``predict`` equal;
- ``BucketingModule`` on ``examples/bucketing_lm.py``'s net (vocab 200,
  hidden 32, Adam, three buckets sharing the default bucket's
  parameters): every batch's output and the parameters after an epoch,
  rtol 1e-4 / atol 1e-5 (Adam carries the gradients' last-bit
  differences into every step);
- ``SequentialModule`` with a ``PythonLossModule`` head, 5 steps;
- ``save_checkpoint`` in one package, ``load_checkpoint`` / ``Module.load``
  in the other: the same outputs; the optimizer states round-trip;
- ``FeedForward``, ``print_summary`` (the same table), ``plot_network``
  (the same graph, and without ``graphviz`` the same ``ImportError``),
  ``SymbolBlock``
  (``imports`` of a checkpoint, deferred shapes) and ``Parameter.var``;
- the cases of ``tests/test_symbol_module.py`` run through the port;
- chip_smoke.py's symbolic ResNet-50 is ``examples/train_imagenet.py``'s
  network, name for name and shape for shape.
"""
import contextlib
import importlib.util
import io as _io
import os
import re
import sys
import types

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.convert import arg_aux_from_numpy  # noqa: E402

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5


def _symbol_tests():
    spec = importlib.util.spec_from_file_location(
        "_torch_symbol_cases", os.path.join(HERE, "test_torch_symbol.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SYM = _symbol_tests()
MODULE_CASES = SYM.load_reference_tests("test_symbol_module")


def example(name, mx):
    """``examples/<name>.py`` as a module over the package ``mx``."""
    path = os.path.join(ROOT, "examples", name + ".py")
    src = open(path).read()
    if mx is tmx:
        src = re.sub(r"\bmxnet_tpu\b", "mxnet_tpu_torch", src)
    mod = types.ModuleType(f"_{name}_{mx.__name__}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def carried(jmod):
    """The JAX module's parameters as the port's NDArrays on the CPU."""
    return arg_aux_from_numpy(*jmod.get_params(), "cpu")


def params_close(tmod, jmod, rtol=RTOL, atol=ATOL):
    (ta, tx), (ja, jx) = tmod.get_params(), jmod.get_params()
    assert sorted(ta) == sorted(ja) and sorted(tx) == sorted(jx)
    for d_t, d_j in ((ta, ja), (tx, jx)):
        for k in d_j:
            np.testing.assert_allclose(d_t[k].asnumpy(), d_j[k].asnumpy(),
                                       rtol=rtol, atol=atol, err_msg=k)


# ------------------------------------------------------------------ fit ---
def _mlp(mx):
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data, name="fc1", num_hidden=128)
    net = mx.sym.Activation(net, act_type="relu", name="r1")
    net = mx.sym.FullyConnected(net, name="fc2", num_hidden=64)
    net = mx.sym.Activation(net, act_type="relu", name="r2")
    net = mx.sym.FullyConnected(net, name="fc3", num_hidden=10)
    return mx.sym.SoftmaxOutput(net, name="softmax")


def test_module_fit_matches_the_reference():
    ex = example("train_mnist_mlp", jmx)
    x, y = ex.synthetic_mnist(512, seed=0)
    xv, yv = ex.synthetic_mnist(128, seed=1)
    kw = dict(num_epoch=2, optimizer="sgd",
              optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    np.random.seed(11)
    jmx.random.seed(0)
    jmod = jmx.mod.Module(_mlp(jmx))
    jmod.bind(data_shapes=[("data", (64, 784))],
              label_shapes=[("softmax_label", (64,))])
    jmod.init_params(initializer=jmx.initializer.Xavier())
    args, auxs = carried(jmod)
    np.random.seed(5)
    jmod.fit(jmx.io.NDArrayIter(x, y, 64, shuffle=True), **kw)
    with tmx.cpu():
        tmod = tmx.mod.Module(_mlp(tmx))
        np.random.seed(5)
        tmod.fit(tmx.io.NDArrayIter(x, y, 64, shuffle=True),
                 arg_params=args, aux_params=auxs, **kw)
        params_close(tmod, jmod)
        tscore = tmod.score(tmx.io.NDArrayIter(xv, yv, 64), "acc")
        tpred = tmod.predict(tmx.io.NDArrayIter(xv, yv, 50)).asnumpy()
    jscore = jmod.score(jmx.io.NDArrayIter(xv, yv, 64), "acc")
    jpred = jmod.predict(jmx.io.NDArrayIter(xv, yv, 50)).asnumpy()
    assert tscore == jscore
    assert tpred.shape == jpred.shape == (128, 10)
    np.testing.assert_allclose(tpred, jpred, rtol=RTOL, atol=ATOL)


def _lm(mx):
    return example("bucketing_lm", mx)


def test_bucketing_module_matches_the_reference():
    B, H, E, V = 8, 32, 16, 200
    buckets = [6, 9, 12]
    state = (1, B, H)
    outs = {}
    mods = {}
    for mx in (jmx, tmx):
        lm = _lm(mx)
        vocab = lm.build_vocab(lm.CORPUS)
        ctx = tmx.cpu() if mx is tmx else contextlib.nullcontext()
        with ctx:
            mod = mx.mod.BucketingModule(lm.make_sym_gen(V, E, H, 1),
                                         default_bucket_key=buckets[-1])
            mod.bind(data_shapes=[("data", (B, buckets[-1])),
                                  ("lstm_state", state),
                                  ("lstm_state_cell", state)],
                     label_shapes=[("softmax_label", (B, buckets[-1]))])
            if mx is jmx:
                jmx.random.seed(0)
                np.random.seed(0)
                mod.init_params(initializer=jmx.initializer.Mixed(
                    [".*lstm_parameters", ".*"],
                    [jmx.initializer.Uniform(0.08),
                     jmx.initializer.Xavier()]))
                start = mod.get_params()
            else:
                mod.init_params(arg_params=arg_aux_from_numpy(
                    *start, "cpu")[0], aux_params={})
            mod.init_optimizer(optimizer="adam",
                               optimizer_params={"learning_rate": 3e-3})
            zero = mx.nd.zeros(state)
            seen = outs[mx.__name__] = []
            for bkey, data, label in lm.bucketize(lm.CORPUS, vocab, buckets,
                                                  B, seed=0)[:12]:
                batch = mx.io.DataBatch(
                    data=[mx.nd.array(data), zero, zero],
                    label=[mx.nd.array(label)], bucket_key=bkey,
                    provide_data=[mx.io.DataDesc("data", (B, bkey)),
                                  mx.io.DataDesc("lstm_state", state),
                                  mx.io.DataDesc("lstm_state_cell", state)],
                    provide_label=[mx.io.DataDesc("softmax_label",
                                                  (B, bkey))])
                mod.forward(batch, is_train=True)
                seen.append((bkey, mod.get_outputs()[0].asnumpy()))
                mod.backward()
                mod.update()
        mods[mx.__name__] = mod
    got, want = outs["mxnet_tpu_torch"], outs["mxnet_tpu"]
    assert [k for k, _ in got] == [k for k, _ in want]
    assert len({k for k, _ in got}) == 3
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    params_close(mods["mxnet_tpu_torch"], mods["mxnet_tpu"])
    tb = mods["mxnet_tpu_torch"]._buckets
    shared = tb[buckets[-1]]._exec.arg_dict["pred_weight"]
    assert all(m._exec.arg_dict["pred_weight"] is shared
               for m in tb.values())


def _chain(mx):
    from_ = mx.module
    d = mx.sym.var("data")
    net = mx.sym.FullyConnected(d, name="fc", num_hidden=4)

    def ce_grad(scores, labels):
        s = scores.asnumpy()
        e = np.exp(s - s.max(axis=1, keepdims=True))
        p = e / e.sum(axis=1, keepdims=True)
        lab = labels.asnumpy().astype(int)
        p[np.arange(len(lab)), lab] -= 1.0
        return mx.nd.array(p / len(lab))
    seq = from_.SequentialModule()
    seq.add(from_.Module(net, label_names=None)) \
       .add(from_.PythonLossModule(grad_func=ce_grad), take_labels=True,
            auto_wiring=True)
    seq.bind(data_shapes=[("data", (8, 6))],
             label_shapes=[("softmax_label", (8,))])
    return seq


def test_sequential_module_with_python_loss_matches_the_reference():
    rs = np.random.RandomState(1)
    x = rs.randn(8, 6).astype(np.float32)
    y = (np.arange(8) % 4).astype(np.float32)
    jseq = _chain(jmx)
    jmx.random.seed(1)
    jseq.init_params(initializer=jmx.initializer.Xavier())
    args, auxs = jseq.get_params()
    res = {}
    for mx, seq in ((jmx, jseq), (tmx, None)):
        ctx = tmx.cpu() if mx is tmx else contextlib.nullcontext()
        with ctx:
            if seq is None:
                seq = _chain(tmx)
                targs, tauxs = arg_aux_from_numpy(args, auxs, "cpu")
                seq.init_params(arg_params=targs, aux_params=tauxs)
            seq.init_optimizer(optimizer="sgd",
                               optimizer_params=(("learning_rate", 1.0),))
            batch = mx.io.DataBatch(data=[mx.nd.array(x)],
                                    label=[mx.nd.array(y)])
            outs = []
            for _ in range(5):
                seq.forward(batch, is_train=True)
                outs.append(seq.get_outputs()[0].asnumpy())
                seq.backward()
                seq.update()
            res[mx.__name__] = (outs, seq.get_params(), seq.output_shapes)
    (tout, tp, tshape), (jout, jp, jshape) = res["mxnet_tpu_torch"], \
        res["mxnet_tpu"]
    assert tshape == jshape == [(8, 4)]
    for g, w in zip(tout, jout):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    for k in jp[0]:
        np.testing.assert_allclose(tp[0][k].asnumpy(), jp[0][k].asnumpy(),
                                   rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------- checkpoints ---
def _bn_net(mx):
    d = mx.sym.var("data")
    c = mx.sym.FullyConnected(d, num_hidden=5, name="fc")
    b = mx.sym.BatchNorm(c, fix_gamma=False, name="bn")
    return mx.sym.SoftmaxOutput(mx.sym.Activation(b, act_type="tanh",
                                                  name="t"), name="softmax")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_load_across_packages(writer, tmp_path):
    x = np.random.RandomState(2).randn(4, 7).astype(np.float32)
    y = np.zeros(4, np.float32)
    prefix = str(tmp_path / "ck")
    shapes = dict(data_shapes=[("data", (4, 7))],
                  label_shapes=[("softmax_label", (4,))])
    jmod = jmx.mod.Module(_bn_net(jmx))
    jmod.bind(**shapes)
    jmod.init_params(initializer=jmx.initializer.Xavier())
    jmod.init_optimizer(optimizer_params={"learning_rate": 0.1})
    jmod.forward_backward(jmx.io.DataBatch([jmx.nd.array(x)],
                                           [jmx.nd.array(y)]))
    jmod.update()
    with tmx.cpu():
        tmod = tmx.mod.Module(_bn_net(tmx))
        tmod.bind(**shapes)
        targs, tauxs = carried(jmod)
        tmod.init_params(arg_params=targs, aux_params=tauxs)
        if writer == "jax":
            jmod.save_checkpoint(prefix, 3)
            loaded = tmx.mod.Module.load(prefix, 3)
            sym, args, auxs = tmx.model.load_checkpoint(prefix, 3)
        else:
            tmod.save_checkpoint(prefix, 3)
            loaded = jmx.mod.Module.load(prefix, 3)
            sym, args, auxs = jmx.model.load_checkpoint(prefix, 3)
        loaded.bind(**shapes)
        assert sym.list_arguments() == jmod.symbol.list_arguments()
        assert sorted(args) == sorted(jmod.get_params()[0])
        assert sorted(auxs) == ["bn_moving_mean", "bn_moving_var"]
        outs = []
        for mod, mx in ((jmod, jmx), (loaded, tmx if writer == "jax"
                                      else jmx)):
            mod.forward(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)]),
                        is_train=False)
            outs.append(mod.get_outputs()[0].asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)


def test_optimizer_states_round_trip(tmp_path):
    with tmx.cpu():
        mod = tmx.mod.Module(_bn_net(tmx))
        mod.bind(data_shapes=[("data", (4, 7))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params(initializer=tmx.initializer.Xavier())
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        batch = tmx.io.DataBatch([tmx.nd.ones((4, 7))], [tmx.nd.zeros((4,))])
        mod.forward_backward(batch)
        mod.update()
        mod.save_checkpoint(str(tmp_path / "s"), 1,
                            save_optimizer_states=True)
        other = tmx.mod.Module.load(str(tmp_path / "s"), 1)
        other.bind(data_shapes=[("data", (4, 7))],
                   label_shapes=[("softmax_label", (4,))])
        other.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        other.load_optimizer_states(str(tmp_path / "s-0001.states"))
        for m in (mod, other):
            m.forward_backward(batch)
            m.update()
        for k, v in mod.get_params()[0].items():
            np.testing.assert_array_equal(other.get_params()[0][k].asnumpy(),
                                          v.asnumpy())


# ---------------------------------------------------------- the others ---
def test_feedforward_matches_the_reference():
    rs = np.random.RandomState(3)
    x = rs.randn(40, 5).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)

    def net(mx):
        d = mx.sym.var("data")
        return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            d, num_hidden=2, name="fc"), name="softmax")
    init = {"fc_weight": rs.randn(2, 5).astype(np.float32) * 0.1,
            "fc_bias": np.zeros(2, np.float32)}
    jff = jmx.model.FeedForward(
        net(jmx), num_epoch=2, numpy_batch_size=8,
        arg_params={k: jmx.nd.array(v) for k, v in init.items()},
        aux_params={})
    jff.fit(x, y)
    with tmx.cpu():
        tff = tmx.model.FeedForward(
            net(tmx), num_epoch=2, numpy_batch_size=8,
            arg_params=arg_aux_from_numpy(init, {}, "cpu")[0],
            aux_params={})
        tff.fit(x, y)
        got = tff.predict(x)
    np.testing.assert_allclose(got, jff.predict(x), rtol=RTOL, atol=ATOL)
    for k in init:
        np.testing.assert_allclose(tff.arg_params[k].asnumpy(),
                                   jff.arg_params[k].asnumpy(), rtol=RTOL,
                                   atol=ATOL)


def test_print_summary_and_plot_network_match_the_reference(monkeypatch):
    texts, dots = [], []
    for mx in (jmx, tmx):
        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            total = mx.viz.print_summary(SYM.conv_bn(mx),
                                         shape={"data": (1, 3, 8, 8)})
        texts.append((total, buf.getvalue()))
        if importlib.util.find_spec("graphviz") is not None:
            dots.append(mx.viz.plot_network(SYM.conv_bn(mx)).source)
    assert texts[1] == texts[0]
    assert texts[1][0] > 0
    assert len(set(dots)) <= 1
    # without graphviz both raise the same ImportError
    monkeypatch.setitem(sys.modules, "graphviz", None)
    for mx in (jmx, tmx):
        with pytest.raises(ImportError, match="requires the graphviz"):
            mx.viz.plot_network(SYM.conv_bn(mx))


def test_symbol_block_imports_a_checkpoint(tmp_path):
    jmod = jmx.mod.Module(_bn_net(jmx))
    jmod.bind(data_shapes=[("data", (4, 7))],
              label_shapes=[("softmax_label", (4,))])
    jmod.init_params(initializer=jmx.initializer.Xavier())
    prefix = str(tmp_path / "sb")
    jmod.save_checkpoint(prefix, 0)
    jsym = jmx.sym.load(prefix + "-symbol.json").get_internals()["t_output"]
    jsym.save(prefix + "-feat-symbol.json")
    x = np.random.RandomState(4).randn(4, 7).astype(np.float32)
    jblock = jmx.gluon.SymbolBlock.imports(prefix + "-feat-symbol.json",
                                           ["data"], prefix + "-0000.params")
    with tmx.cpu():
        tblock = tmx.gluon.SymbolBlock.imports(
            prefix + "-feat-symbol.json", ["data"], prefix + "-0000.params",
            ctx="cpu")
        got = tblock(torch.from_numpy(x))
    assert sorted(tblock.collect_params().keys()) == \
        sorted(jblock.collect_params().keys())
    np.testing.assert_allclose(got.detach().numpy(),
                               jblock(jmx.nd.array(x)).asnumpy(),
                               rtol=1e-5, atol=1e-6)
    # deferred shapes from the first input, and Parameter.var
    with tmx.cpu():
        d = tmx.sym.var("data")
        block = tmx.gluon.SymbolBlock(
            tmx.sym.FullyConnected(d, num_hidden=3, name="h"), d)
        block.initialize(ctx="cpu")
        assert block(torch.ones(2, 5)).shape == (2, 3)
        w = block.collect_params()["h_weight"]
        assert w.shape == (3, 5) and w.var().name == "h_weight"


def test_chip_smoke_resnet_is_the_example_network():
    ex = example("train_imagenet", jmx)
    want = ex.get_resnet_symbol(1000, 50, (3, 224, 224))
    got = chip_smoke.symbolic_resnet(tmx, 1000, 50)
    assert got.list_arguments() == want.list_arguments()
    assert got.list_auxiliary_states() == want.list_auxiliary_states()
    assert got.list_outputs() == want.list_outputs()
    shapes = dict(data=(2, 3, 224, 224), softmax_label=(2,))
    assert got.infer_shape(**shapes) == want.infer_shape(**shapes)


@pytest.mark.parametrize("case", list(MODULE_CASES))
def test_symbol_module_case_through_the_port(case, tmp_path):
    SYM.run_reference_test(MODULE_CASES[case], tmp_path)

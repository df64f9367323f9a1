"""PyTorch port, gluon blocks' NDArray callers (ROADMAP §3 item 21): a
block called with NDArrays returns NDArrays over the tensors it computes
(no copy; a tuple or list keeps its structure), a block called with
tensors returns tensors, and a child called inside a forward gets
tensors. Held against the JAX package where it has the same thing:

- ``examples/sparse_linear_classification.py`` through both packages:
  the same printed per-epoch logistic loss and accuracy (four and three
  decimals); it also needs an attached array to stay a leaf after
  ``weight -= lr * weight.grad``;
- the JAX suite's gluon cases that read a block's output with
  ``asnumpy()`` run through the port by text substitution;
- eager, hybridized and ``compile_step`` outputs for NDArray callers are
  a tensor caller's, bit for bit, and ``unroll`` follows the same rule.
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

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import autograd as ag, gluon  # noqa: E402
from mxnet_tpu_torch.gluon import nn  # noqa: E402

torch.set_num_threads(2)


def _symbol_tests():
    spec = importlib.util.spec_from_file_location(
        "_torch_symbol_cases_nd", os.path.join(HERE, "test_torch_symbol.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SYM = _symbol_tests()
# the JAX suite's gluon cases that read a block's (or an unroll's) output
# through asnumpy(); the others of those files read Parameter.data() or
# .grad() as NDArrays, which the port hands out as tensors (ROADMAP §3
# item 22)
GLUON_CASES = {
    "test_gluon": ["test_dense", "test_dense_deferred_shape",
                   "test_hybrid_matches_eager",
                   "test_dropout_active_only_in_training",
                   "test_conv_layers_shapes", "test_norm_layers",
                   "test_activations_layers", "test_save_load_parameters",
                   "test_losses", "test_softmax_ce_loss_value",
                   "test_hybrid_rng_varies_per_call", "test_lambda_blocks"],
    "test_gluon_contrib_nn": ["test_concurrent_concats_branches",
                              "test_pixelshuffle_oracles"],
    "test_gluon_contrib_rnn": ["test_conv_lstm_cell_step_and_unroll",
                               "test_variational_dropout_mask_is_fixed_"
                               "per_unroll"],
}
_LOADED = {}


def _case(file, name):
    if file not in _LOADED:
        _LOADED[file] = SYM.load_reference_tests(file)
    return _LOADED[file][name]


@pytest.mark.parametrize("file,name", [
    (f, n) for f, names in GLUON_CASES.items() for n in names])
def test_reference_gluon_case_through_the_port(file, name, tmp_path):
    SYM.run_reference_test(_case(file, name), tmp_path)


@pytest.mark.parametrize("hybridize", [False, True])
def test_reference_training_case_through_the_port(hybridize):
    fn = _case("test_gluon", "test_sequential_training_decreases_loss")
    np.random.seed(0)
    tmx.random.seed(0)
    with tmx.cpu():
        fn(hybridize=hybridize)


def _example(name, mx):
    path = os.path.join(ROOT, "examples", name + ".py")
    src = open(path).read()
    if mx is tmx:
        src = re.sub(r"\bmxnet_tpu\b", "mxnet_tpu_torch", src)
    mod = types.ModuleType(f"_{name}_{mx.__name__}_nd")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def test_sparse_linear_classification_matches_the_reference(monkeypatch):
    argv = ["sparse_linear_classification.py", "--epochs", "3",
            "--num-samples", "384", "--num-features", "200"]
    printed = {}
    for mx in (jmx, tmx):
        ex = _example("sparse_linear_classification", mx)
        monkeypatch.setattr(sys, "argv", argv)
        out = _io.StringIO()
        ctx = tmx.cpu() if mx is tmx else contextlib.nullcontext()
        with contextlib.redirect_stdout(out), ctx:
            assert ex.main() == 0
        printed[mx] = out.getvalue().splitlines()
    assert len(printed[tmx]) == 3
    assert printed[tmx] == printed[jmx]


def _dense(prefix):
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu", in_units=5),
                nn.Dense(3, in_units=8))
    net.initialize(device="cpu", generator=torch.Generator().manual_seed(1))
    return net


X = np.random.RandomState(0).randn(4, 5).astype(np.float32)


class _Pair(nn.Block):
    """Returns a nested structure, and records what its child saw."""

    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.body = nn.Dense(3, in_units=5)
        self.seen = []
        self.body.register_forward_hook(
            lambda blk, inp, out: self.seen.append((type(inp[0]),
                                                    type(out))))

    def forward(self, x, scale=None):
        y = self.body(x)
        return y, [y * 2, {"raw": y}]


def test_ndarray_callers_get_ndarrays_tensor_callers_tensors():
    with tmx.cpu():
        blk = _Pair(prefix="ndpair_")
        blk.initialize(device="cpu",
                       generator=torch.Generator().manual_seed(0))
        xt = torch.from_numpy(X)
        xn = tmx.nd.array(X, ctx="cpu")
        t = blk(xt)
        n = blk(xn, scale=tmx.nd.ones((1,), ctx="cpu"))
    # the child inside forward saw tensors both times
    assert blk.seen == [(torch.Tensor, torch.Tensor)] * 2
    assert isinstance(t[0], torch.Tensor) and isinstance(t[1], list)
    assert isinstance(n, tuple) and isinstance(n[1], list)
    assert isinstance(n[0], tmx.nd.NDArray)
    assert isinstance(n[1][0], tmx.nd.NDArray)
    # a dict is an opaque leaf, as in the reference: handed on as it is
    assert isinstance(n[1][1], dict) and torch.is_tensor(n[1][1]["raw"])
    assert torch.equal(n[0]._data, t[0]) and torch.equal(n[1][0]._data,
                                                         t[1][0])
    # no copy: the NDArray is over the tensor the block computed
    assert n[1][1]["raw"].data_ptr() == n[0]._data.data_ptr()


def test_hybridized_outputs_and_gradients_unchanged():
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    y = np.array([0, 1, 2, 1], np.float32)
    with tmx.cpu():
        for hybrid in (False, True):
            outs, grads = [], []
            for feed in (lambda a: torch.from_numpy(a),
                         lambda a: tmx.nd.array(a, ctx="cpu")):
                net = _dense(f"ndhyb{int(hybrid)}_")
                if hybrid:
                    net.hybridize()
                    net(feed(X))
                with ag.record():
                    loss = loss_fn(net(feed(X)), feed(y))
                if torch.is_tensor(loss):
                    ag.backward(loss)
                else:
                    loss.backward()         # NDArray.backward
                outs.append(tmx.nd.NDArray(net(feed(X))).asnumpy())
                grads.append([p.grad().clone() for p in
                              net.collect_params().values()])
                assert isinstance(loss, tmx.nd.NDArray) == (
                    not torch.is_tensor(feed(X)))
            np.testing.assert_array_equal(outs[0], outs[1])
            for a, b in zip(*grads):
                assert torch.equal(a, b)


def test_compiled_step_outputs_unchanged():
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rs = np.random.RandomState(4)
    xs = rs.randn(3, 4, 5).astype(np.float32)
    ys = (np.arange(12).reshape(3, 4) % 3).astype(np.float32)
    runs = []
    with tmx.cpu():
        for wrap in (False, True):
            net = _dense(f"ndcomp{int(wrap)}_")
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
            step = tr.compile_step(lambda a, b, net=net: loss_fn(net(a), b))
            feed = (lambda a: tmx.nd.array(a, ctx="cpu")) if wrap else \
                torch.from_numpy
            losses = [step(feed(x), feed(y)) for x, y in zip(xs, ys)]
            assert all(isinstance(v, tmx.nd.NDArray) == wrap
                       for v in losses)
            runs.append(([tmx.nd.NDArray(v).asnumpy() for v in losses],
                         [p.data().clone() for p in
                          net.collect_params().values()]))
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_unroll_follows_its_callers():
    with tmx.cpu():
        cell = gluon.rnn.LSTMCell(6, input_size=5, prefix="ndunroll_")
        cell.initialize(device="cpu",
                        generator=torch.Generator().manual_seed(2))
        seq = np.random.RandomState(5).randn(2, 3, 5).astype(np.float32)
        t_out, t_states = cell.unroll(3, torch.from_numpy(seq))
        n_out, n_states = cell.unroll(3, tmx.nd.array(seq, ctx="cpu"))
    assert torch.is_tensor(t_out) and all(torch.is_tensor(s)
                                          for s in t_states)
    assert isinstance(n_out, tmx.nd.NDArray)
    assert all(isinstance(s, tmx.nd.NDArray) for s in n_states)
    assert torch.equal(n_out._data, t_out)


def test_inplace_update_keeps_an_attached_leaf():
    """``w -= lr * w.grad`` rebinds the array and keeps it a leaf: the
    next backward writes its ``.grad`` again (the JAX package's
    numbers)."""
    rs = np.random.RandomState(6)
    x, w0 = rs.randn(4, 3).astype(np.float32), rs.randn(3, 1).astype(
        np.float32)
    got = {}
    for mx in (jmx, tmx):
        ctx = tmx.cpu() if mx is tmx else contextlib.nullcontext()
        with ctx:
            w = mx.nd.array(w0)
            w.attach_grad()
            xs = mx.nd.array(x)
            seen = []
            for _ in range(3):
                with mx.autograd.record():
                    loss = (mx.nd.dot(xs, w) ** 2).sum()
                loss.backward()
                seen.append(w.grad.asnumpy().copy())
                w -= 0.01 * w.grad
            got[mx] = seen + [w.asnumpy()]
    for a, b in zip(got[tmx], got[jmx]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert not np.array_equal(got[tmx][0], got[tmx][1])

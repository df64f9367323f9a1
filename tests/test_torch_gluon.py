"""PyTorch port, gluon: layers, losses, autograd scopes, parameters and the
Trainer of ``mxnet_tpu_torch`` against the JAX package's, with the JAX
weights carried across by ``convert.load_gluon_params`` and the same
numpy inputs.

Tolerances, each with its reason:

- ``FWD_TOL = 1e-5`` — forward outputs: the same f32 ops (one matmul,
  a mean/variance, an erf) with sums in another order; outputs are O(1).
- ``GRAD_TOL = 2e-5`` — parameter gradients: sums over the batch of
  O(1) products in another order.
- ``OPT_TOL = 1e-6`` — weights after three optimizer steps on the same
  gradients: the same elementwise f32 update, lr at most 0.1; only the
  last bit of each operation may differ.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.autograd as jag  # noqa: E402
from mxnet_tpu import gluon as jgluon, nd  # noqa: E402
from mxnet_tpu.gluon import nn as jnn  # noqa: E402
from mxnet_tpu.gluon.model_zoo import bert as jbert  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu_torch import autograd as tag  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch import initializer as tinit  # noqa: E402
from mxnet_tpu_torch.convert import load_gluon_params  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tnn  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert  # noqa: E402

torch.set_num_threads(2)

FWD_TOL = 1e-5
GRAD_TOL = 2e-5
OPT_TOL = 1e-6


def _arrays(jblock):
    return {k: v.data().asnumpy() for k, v in
            jblock.collect_params().items()}


def _rel(block, params):
    return {k[len(block.prefix):]: v for k, v in params.items()}


def _close(a, b, tol, what=""):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)


def _run_jax(block, inputs, gout, kwargs=None, input_grad=True):
    """Forward under record, loss = sum(out * gout), backward: (out,
    {rel name: grad}, with the first input's gradient as "input")."""
    kwargs = kwargs or {}
    xs = [nd.array(x) for x in inputs]
    if input_grad:
        xs[0].attach_grad()
    with jag.record():
        out = block(*xs, **{k: nd.array(v) for k, v in kwargs.items()})
        loss = (out * nd.array(gout)).sum()
    loss.backward()
    grads = {k: v.grad().asnumpy()
             for k, v in _rel(block, block.collect_params()).items()}
    if input_grad:
        grads["input"] = xs[0].grad.asnumpy()
    return out.asnumpy(), grads


def _run_port(block, inputs, gout, kwargs=None, input_grad=True):
    kwargs = kwargs or {}
    xs = [torch.from_numpy(x) for x in inputs]
    if input_grad:
        xs[0].requires_grad_()
    with tag.record():
        out = block(*xs, **{k: torch.from_numpy(v)
                            for k, v in kwargs.items()})
        loss = (out * torch.from_numpy(gout)).sum()
    loss.backward()
    grads = {k: v.grad().numpy()
             for k, v in _rel(block, block.collect_params()).items()}
    if input_grad:
        grads["input"] = xs[0].grad.numpy()
    return out.detach().numpy(), grads


def _layer_case(kind, rng):
    """(JAX block, port block, inputs, kwargs)."""
    x3 = rng.randn(2, 5, 8).astype(np.float32)
    if kind == "dense_flatten_false":
        return (jnn.Dense(6, flatten=False), tnn.Dense(6, flatten=False),
                [x3], {})
    if kind == "dense_flatten":
        return (jnn.Dense(6, activation="tanh"),
                tnn.Dense(6, activation="tanh"), [x3], {})
    if kind == "layernorm":
        return jnn.LayerNorm(), tnn.LayerNorm(), [x3 * 3 + 1], {}
    if kind == "embedding":
        idx = rng.randint(0, 10, size=(3, 4)).astype(np.float32)
        return jnn.Embedding(10, 8), tnn.Embedding(10, 8), [idx], {}
    if kind == "gelu":
        return (jnn.Activation("gelu"), tnn.Activation("gelu"),
                [x3 * 2], {})
    if kind == "sequential":
        nets = []
        for nn_ in (jnn, tnn):
            net = nn_.HybridSequential()
            with net.name_scope():
                net.add(nn_.Dense(6, activation="relu", flatten=False),
                        nn_.Dense(3, flatten=False))
            nets.append(net)
        return nets[0], nets[1], [x3], {}
    if kind == "mha":
        mask = np.zeros((2, 5), np.float32)
        mask[1, 3:] = -1e30
        return (jnn.MultiHeadAttention(16, 2),
                tnn.MultiHeadAttention(16, 2),
                [rng.randn(2, 5, 16).astype(np.float32)], {"mask": mask})
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["dense_flatten_false", "dense_flatten",
                                  "layernorm", "embedding", "gelu",
                                  "sequential", "mha"])
def test_layer_forward_and_grads_match_jax(kind):
    rng = np.random.RandomState(0)
    jb, tb, inputs, kwargs = _layer_case(kind, rng)
    mx.random.seed(1)
    jb.initialize(mx.initializer.Xavier())
    tb.initialize(tinit.Xavier(), device="cpu")
    with jag.pause():   # resolve JAX's deferred shapes
        out = jb(*[nd.array(x) for x in inputs],
                 **{k: nd.array(v) for k, v in kwargs.items()})
    load_gluon_params(tb, _arrays(jb))
    gout = rng.randn(*out.shape).astype(np.float32)
    wrt_input = kind != "embedding"     # indices have no gradient
    j_out, j_grads = _run_jax(jb, inputs, gout, kwargs, wrt_input)
    t_out, t_grads = _run_port(tb, inputs, gout, kwargs, wrt_input)
    _close(t_out, j_out, FWD_TOL, "out")
    assert sorted(t_grads) == sorted(j_grads)
    for name in j_grads:
        _close(t_grads[name], j_grads[name], GRAD_TOL, name)


def test_deferred_init_materialises_on_first_forward():
    d = tnn.Dense(4, flatten=False)
    d.initialize(device="cpu", generator=torch.Generator().manual_seed(0))
    trainer = tgluon.Trainer(d.collect_params(), "adam",
                             {"learning_rate": 0.1})
    assert d.weight.shape == (4, 0)
    with pytest.raises(tgluon.DeferredInitializationError):
        d.weight.data()
    assert [n for n, _ in d.named_parameters()] == ["bias"]
    x = torch.ones(2, 3, 5)
    with tag.record():
        y = d(x)
    y.sum().backward()
    assert d.weight.shape == (4, 5) and y.shape == (2, 3, 4)
    assert dict(d.named_parameters())["weight"] is d.weight.data()
    before = d.weight.data().detach().clone()
    trainer.step(1)   # the trainer sees the parameter made after it
    assert not torch.equal(before, d.weight.data())


def test_collect_params_names_and_shapes_match_jax():
    kw = dict(vocab_size=40, units=16, hidden_size=32, num_layers=2,
              num_heads=2, max_length=20, dropout=0.1)
    jm = jbert.BERTModel(flash=False, **kw)
    tm = tbert.BERTModel(flash=False, **kw)
    jm.initialize()
    tm.initialize(device="cpu")
    tokens = np.array([[3, 4, 5, 6]], np.float32)
    with jag.pause():
        jm(nd.array(tokens))
    tm(torch.from_numpy(tokens))
    j = {k: v.shape for k, v in _rel(jm, jm.collect_params()).items()}
    t = {k: v.shape for k, v in _rel(tm, tm.collect_params()).items()}
    assert list(t) == list(j)
    assert t == j
    # every parameter is also a registered nn.Parameter of the module
    assert len(list(tm.parameters())) == len(t)
    sel = r".*layer1_.*_weight$"
    assert [k[len(tm.prefix):] for k in tm.collect_params(sel).keys()] == \
        [k[len(jm.prefix):] for k in jm.collect_params(sel).keys()]
    assert len(tm.collect_params(sel)) == 6


def test_module_conversion_keeps_gluon_parameters_in_sync():
    """An ``nn.Module`` conversion that makes new tensors (as a move
    across devices does) leaves ``Parameter.data()`` on the registered
    tensor, with the write semantics of its gradient."""
    d = tnn.Dense(3, in_units=2)
    d.initialize(device="cpu")
    old = d.weight.data()
    prev = torch.__future__.get_overwrite_module_params_on_conversion()
    torch.__future__.set_overwrite_module_params_on_conversion(True)
    try:
        d.double()
    finally:
        torch.__future__.set_overwrite_module_params_on_conversion(prev)
    w = d.weight.data()
    assert w is not old and w is dict(d.named_parameters())["weight"]
    assert w.dtype == torch.float64
    x = torch.ones(4, 2, dtype=torch.float64)
    for _ in range(2):
        with tag.record():
            y = d(x).sum()
        y.backward()
    assert torch.equal(d.weight.grad(), torch.full((3, 2), 4.0,
                                                   dtype=torch.float64))


def test_load_gluon_params_rejects_mismatches():
    jd, td = jnn.Dense(3, in_units=2), tnn.Dense(3, in_units=2)
    jd.initialize()
    td.initialize(device="cpu")
    arrays = _arrays(jd)
    load_gluon_params(td, arrays)
    np.testing.assert_array_equal(td.weight.data().detach().numpy(),
                                  jd.weight.data().asnumpy())
    bad = dict(arrays)
    bad.pop(next(k for k in bad if k.endswith("bias")))
    with pytest.raises(KeyError, match="missing"):
        load_gluon_params(td, bad)
    with pytest.raises(KeyError, match="extra"):
        load_gluon_params(td, dict(arrays, **{jd.prefix + "gamma": 1.0}))
    wrong = {k: (np.zeros((3, 3), np.float32) if k.endswith("weight")
                 else v) for k, v in arrays.items()}
    with pytest.raises(ValueError):
        load_gluon_params(td, wrong)


def test_softmax_cross_entropy_matches_jax():
    rng = np.random.RandomState(2)
    pred = rng.randn(6, 7).astype(np.float32) * 3
    label = rng.randint(0, 7, size=6).astype(np.float32)
    sw = rng.rand(6, 1).astype(np.float32)
    jl = jgluon.loss.SoftmaxCrossEntropyLoss()
    tl = tgluon.loss.SoftmaxCrossEntropyLoss()
    for args in ((pred, label), (pred, label, sw)):
        want = jl(*[nd.array(a) for a in args]).asnumpy()
        got = tl(*[torch.from_numpy(a) for a in args]).numpy()
        assert got.shape == (6,)
        _close(got, want, FWD_TOL)
    dense = np.eye(7, dtype=np.float32)[label.astype(int)]
    want = jgluon.loss.SoftmaxCrossEntropyLoss(sparse_label=False)(
        nd.array(pred), nd.array(dense)).asnumpy()
    got = tgluon.loss.SoftmaxCrossEntropyLoss(sparse_label=False)(
        torch.from_numpy(pred), torch.from_numpy(dense)).numpy()
    _close(got, want, FWD_TOL)


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_trainer_three_steps_match_jax(name):
    """Three ``step``s on the same gradients: wd, rescale_grad (scale /
    batch_size), clip_gradient, an lr_mult and per-index step counts
    (one parameter skips the second step's gradient change)."""
    rng = np.random.RandomState(3)
    jd, td = jnn.Dense(4, in_units=3), tnn.Dense(4, in_units=3)
    jd.initialize()
    td.initialize(device="cpu")
    load_gluon_params(td, _arrays(jd))
    for d in (jd, td):
        d.bias.lr_mult = 0.5
    opts = {"learning_rate": 0.1, "wd": 0.01, "clip_gradient": 0.3,
            "rescale_grad": 2.0, "beta1": 0.8}
    jt = jgluon.Trainer(jd.collect_params(), name, dict(opts))
    tt = tgluon.Trainer(td.collect_params(), name, dict(opts))
    for step in range(3):
        for jp, tp in ((jd.weight, td.weight), (jd.bias, td.bias)):
            g = rng.randn(*jp.shape).astype(np.float32)
            jp.grad()[:] = g
            tp.grad().copy_(torch.from_numpy(g))
        jt.step(4)
        tt.step(4)
        for jp, tp in ((jd.weight, td.weight), (jd.bias, td.bias)):
            _close(tp.data().detach().numpy(), jp.data().asnumpy(),
                   OPT_TOL, f"{tp.name} after step {step}")
    assert tt.optimizer._index_update_count == {0: 3, 1: 3}


def test_grad_req_write_replaces_and_add_accumulates():
    """Two record/backward passes with no step between: ``write`` keeps
    only the second pass's gradient (as the JAX package does), ``add``
    the sum."""
    rng = np.random.RandomState(4)
    x1, x2 = (rng.randn(3, 2).astype(np.float32) for _ in range(2))
    jd, td = jnn.Dense(2, in_units=2), tnn.Dense(2, in_units=2)
    jd.initialize()
    td.initialize(device="cpu")
    load_gluon_params(td, _arrays(jd))
    for x in (x1, x2):
        with jag.record():
            jl = (jd(nd.array(x)) ** 2).sum()
        jl.backward()
        with tag.record():
            tl = (td(torch.from_numpy(x)) ** 2).sum()
        tl.backward()
    _close(td.weight.grad().numpy(), jd.weight.grad().asnumpy(), GRAD_TOL)
    second = td.weight.grad().clone()
    td.weight.grad_req = "add"
    with tag.record():
        tl = (td(torch.from_numpy(x2)) ** 2).sum()
    tl.backward()
    _close(td.weight.grad().numpy(), 2 * second.numpy(), GRAD_TOL)


def test_autograd_scopes_and_dropout_mode():
    x = torch.ones(4000)
    drop = tnn.Dropout(0.5, generator=torch.Generator().manual_seed(0))
    assert not tag.is_recording() and not tag.is_training()
    assert torch.equal(drop(x), x)               # predict mode: identity
    with tag.record():
        assert tag.is_recording() and tag.is_training()
        assert torch.is_grad_enabled()
        y = drop(x)
        with tag.pause():
            assert not tag.is_recording() and not torch.is_grad_enabled()
            assert torch.equal(drop(x), x)
    assert set(y.unique().tolist()) == {0.0, 2.0}
    assert 1700 < int((y == 0).sum()) < 2300
    with tag.train_mode():
        assert tag.is_training() and not tag.is_recording()
    with tag.record(train_mode=False):
        assert torch.equal(drop(x), x)
    with tag.record(), tag.predict_mode():
        assert not tag.is_training() and tag.is_recording()

"""PyTorch port, the NDArray class and autograd: the cases of
tests/test_ndarray.py, tests/test_autograd.py and
tests/test_higher_order_grad.py, each run on the JAX package's ``nd``
and ``autograd`` and on the port's, on the same data, their results
compared (exact but where a tolerance is stated: rtol 1e-5 for f32
arithmetic, 1e-4 for the higher-order gradients); the AMP cast of an
f16 reduction method (the NDArray method goes through the op
chokepoint); and the facade's boundary: torch functions take an NDArray,
a gluon block called on one returns what it returns on the tensor.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import autograd as tag  # noqa: E402
from mxnet_tpu_torch import nd as tnd  # noqa: E402

torch.set_num_threads(2)


class _Side:
    """One package's ``nd``, ``autograd`` and the ctx its arrays take."""

    def __init__(self, nd, ag, ctx):
        self.nd, self.ag, self.ctx = nd, ag, ctx

    def array(self, a, dtype=None):
        if self.ctx is None:
            return self.nd.array(a, dtype=dtype)
        return self.nd.array(a, ctx=self.ctx, dtype=dtype)

    def kw(self):
        return {} if self.ctx is None else {"ctx": self.ctx}


JAX = _Side(mx.nd, mx.autograd, None)
PORT = _Side(tnd, tag, "cpu")


def _np(v):
    if hasattr(v, "asnumpy"):
        return np.asarray(v.asnumpy())
    if isinstance(v, (tuple, list)):
        return [_np(x) for x in v]
    return v


def _same(fn, rtol=0.0, atol=0.0):
    """Run ``fn(side)`` on both packages; every result (a dict) must
    match: arrays in shape, dtype name and value, the rest equal."""
    want, got = fn(JAX), fn(PORT)
    assert want.keys() == got.keys()
    for k in want:
        w, g = want[k], got[k]
        if hasattr(w, "asnumpy") or hasattr(g, "asnumpy"):
            assert tuple(g.shape) == tuple(w.shape), k
            assert np.dtype(g.dtype).name == np.dtype(w.dtype).name, k
            np.testing.assert_allclose(_np(g), _np(w), rtol=rtol,
                                       atol=atol, err_msg=k)
        elif isinstance(w, (list, tuple)) and w and hasattr(w[0],
                                                            "asnumpy"):
            assert len(g) == len(w), k
            for a, b in zip(g, w):
                np.testing.assert_allclose(_np(a), _np(b), rtol=rtol,
                                           atol=atol, err_msg=k)
        elif isinstance(w, float):
            assert g == pytest.approx(w, rel=rtol, abs=atol), k
        else:
            assert g == w, (k, g, w)


X = np.arange(12, dtype=np.float32).reshape(3, 4)
Y = np.random.RandomState(0).randn(3, 4).astype(np.float32)


# ------------------------------------------------------------ ndarray --
def _creation(s):
    nd = s.nd
    return {
        "array": s.array([[1, 2], [3, 4]]),
        "f64": s.array(np.ones(3)),
        "int": s.array(np.arange(3, dtype=np.int32)),
        "zeros": nd.zeros((2, 3), **s.kw()),
        "ones": nd.ones(4, dtype="int32", **s.kw()),
        "full": nd.full((2, 2), 7.5, **s.kw()),
        "empty_shape": nd.empty((2, 5), **s.kw()).shape,
        "arange": nd.arange(1, 7, 1.5, repeat=2, **s.kw()),
        "linspace": nd.linspace(0, 1, 5, **s.kw()),
        "eye": nd.eye(3, 4, 1, **s.kw()),
        "size": nd.zeros((2, 3, 4), **s.kw()).size,
        "ndim": nd.zeros((2, 3, 4), **s.kw()).ndim,
        "dtype": str(s.array(X).dtype),
    }


def _arithmetic(s):
    a, b = s.array(X), s.array(Y)
    return {"add": a + b, "radd": 2 + a, "sub": a - b, "rsub": 1 - a,
            "mul": a * b, "div": a / (b + 10), "rdiv": 1 / (a + 1),
            "pow": a ** 2, "rpow": 2 ** (a / 10), "mod": a % 5,
            "rmod": 7 % (a + 1), "neg": -b, "abs": abs(b),
            "eq": a == 5, "ne": a != 5, "gt": a > b, "ge": a >= 4,
            "lt": a < b, "le": a <= 4, "bcast": a + s.array(Y[:1]),
            "npmix": a + Y}


def _inplace(s):
    a = s.array(X)
    a += 1
    a *= 2
    a -= s.array(Y)
    a /= 4
    return {"a": a}


def _indexing(s):
    a = s.array(X)
    b = s.array(X)
    b[1] = 0
    b[:, 2] = s.array(np.array([7.0, 8.0, 9.0], np.float32))
    c = s.array(X)
    c[:] = 5
    idx = s.array(np.array([2, 0], np.float32))
    return {"row": a[1], "slice": a[1:, ::2], "scalar": a[2, 3],
            "adv": a[idx], "set": b, "setall": c,
            "len": len(a), "iter": [r for r in a]}


def _shapes(s):
    a = s.array(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
    return {"r0": a.reshape(0, -1), "r3": a.reshape(-3, 4),
            "r4": a.reshape(2, -4, 3, 1, -2), "r2": a.reshape((-2,)),
            "rkw": a.reshape(shape=(4, 6)), "t": a.transpose(),
            "taxes": a.transpose(1, 0, 2), "T": s.array(X).T,
            "flat": a.flatten(), "exp": a.expand_dims(1),
            "sq": a.expand_dims(0).squeeze(), "swap": a.swapaxes(0, 2),
            "tile": s.array(X).tile((2, 1)),
            "repeat": s.array(X).repeat(2, axis=1),
            "repeat_flat": s.array(X).repeat(2),
            "bto": s.array(X[:1]).broadcast_to((3, 4)),
            "flip": a.flip(2), "clip": s.array(Y).clip(-0.5, 0.5),
            "slice_axis": a.slice_axis(2, 1, 3),
            "pad": a.reshape(1, 2, 3, 4).pad("constant",
                                             (0, 0, 0, 0, 1, 1, 2, 2), 1.5),
            "one_hot": s.array(np.array([0, 2, 1], np.float32)).one_hot(3),
            "take": s.array(X).take(s.array(np.array([2.0, 0.0])))}


def _reductions(s):
    a = s.array(Y)
    return {"sum": a.sum(), "sum1": a.sum(axis=1), "mean0": a.mean(axis=0),
            "meank": a.mean(axis=1, keepdims=True), "prod": a.prod(axis=0),
            "max": a.max(), "max1": a.max(axis=1), "min": a.min(axis=0),
            "norm": a.norm(), "norm1": a.norm(ord=1, axis=1),
            "argmax": a.argmax(axis=1), "argmin": a.argmin(),
            "sort": a.sort(axis=1), "sortd": a.sort(is_ascend=False),
            "argsort": a.argsort(axis=0),
            "topk": a.topk(k=2), "topkv": a.topk(k=2, ret_typ="value"),
            "split": a.split(2, axis=1), "split0": a.split(3, axis=0),
            "dot": a.dot(s.array(Y.T)), "dott": a.dot(a, transpose_b=True),
            "exp": a.exp(), "sqrt": abs(a).sqrt(), "log": (abs(a) + 1).log(),
            "relu": a.relu(), "sigmoid": a.sigmoid(), "tanh": a.tanh(),
            "softmax": a.softmax(), "log_softmax": a.log_softmax(axis=0),
            "square": a.square(), "zl": a.zeros_like(), "ol": a.ones_like(),
            "scalar": float(a.sum()), "int": int(s.array([3.0])),
            "asscalar": s.array([2.5]).asscalar()}


def _dtypes_and_copies(s):
    a = s.array(X)
    b = a.astype("int32")
    c = a.copy()
    c += 1
    d = s.nd.zeros((3, 4), **s.kw())
    a.copyto(d)
    e = a.detach()
    return {"astype": b, "same": a.astype("float32", copy=False) is a,
            "copy": c, "orig": a, "copyto": d, "detach": e,
            "as_in": a.as_in_context(a.context) is a,
            "tolist": a.tolist(), "stype": a.stype}


def _generated_ops(s):
    nd = s.nd
    a, b = s.array(Y), s.array(X)
    return {"exp": nd.exp(a), "sum": nd.sum(a, axis=1),
            "reshape": nd.reshape(b, shape=(2, 6)),
            "concat": nd.concat(a, b, dim=0),
            "concat_list": nd.concat([a, b], dim=1),
            "stack": nd.stack(a, b, axis=1), "add_n": nd.add_n(a, b, a),
            "one_hot": nd.one_hot(s.array([0, 2]), 3),
            "dot_pos": nd.dot(a, b, False, True),
            "gemm2": nd.linalg.gemm2(a, b, transpose_b=True),
            "op_ns": nd.op.relu(a),
            "concatenate": nd.concatenate([a, b], axis=1),
            "invoke": nd.imperative_invoke("broadcast_add", a, b),
            "split": nd.split(a, num_outputs=2, axis=1)}


@pytest.mark.parametrize("case", [_creation, _arithmetic, _inplace,
                                  _indexing, _shapes, _reductions,
                                  _dtypes_and_copies, _generated_ops],
                         ids=lambda f: f.__name__.strip("_"))
def test_ndarray_methods_match_jax(case):
    _same(case, rtol=1e-5, atol=1e-6)


def test_save_load_returns_ndarrays(tmp_path):
    a = tnd.array(Y, ctx="cpu")
    p = str(tmp_path / "a.params")
    tnd.save(p, {"a": a, "b": tnd.array(X, ctx="cpu")})
    back = tnd.load(p)
    jback = mx.nd.load(p)
    assert isinstance(back["a"], tnd.NDArray)
    for k in ("a", "b"):
        np.testing.assert_array_equal(back[k].asnumpy(), jback[k].asnumpy())
    tnd.save(p, [a])
    (only,) = tnd.load(p)
    np.testing.assert_array_equal(only.asnumpy(), Y)


def test_wait_to_read_and_context():
    a = tnd.array(X, ctx="cpu")
    a.wait_to_read()
    tnd.waitall()
    assert a.context == tmx.cpu() and a.ctx == a.context
    assert a.as_in_context("cpu") is a
    with pytest.raises(ValueError):
        bool(a)
    assert bool(tnd.array([1.0], ctx="cpu"))


# ----------------------------------------------------------- autograd --
def _grads(s):
    ag = s.ag
    out = {}
    x = s.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with ag.record():
        y = (x * x).sum()
    y.backward()
    out["simple"] = x.grad
    with ag.record():
        z = s.nd.exp(s.nd.sin(x) * 2).sum()
    z.backward()
    out["chain"] = x.grad
    with ag.record():
        w = x * 3
    w.backward(s.array([1.0, 0.5, 2.0]))
    out["head"] = x.grad
    with ag.record():
        u = x * x + x * 2 + x
    u.backward()
    out["multi_use"] = x.grad
    with ag.record():
        v = x * 2
        with ag.pause():
            c = x * 10
        v = v + c
    v.backward()
    out["pause"] = x.grad
    with ag.record():
        q = (x ** 3).sum()
    out["grad_fn"] = ag.grad(q, [x])[0]
    with ag.record():
        r = x * x
    r.backward(retain_graph=True)
    g1 = x.grad.asnumpy().copy()
    r.backward()
    out["retain"] = (g1 == x.grad.asnumpy()).all()
    a = s.array([1.0])
    a.attach_grad(grad_req="add")
    for k in (2.0, 3.0):
        with ag.record():
            t = a * k
        t.backward()
    out["add"] = a.grad
    m = s.array([2.0])
    buf = s.nd.zeros((1,), **s.kw())
    ag.mark_variables([m], [buf])
    with ag.record():
        n = m * 5
    n.backward()
    out["mark"] = m.grad
    with ag.record(train_mode=False):
        out["rec_pred"] = (ag.is_recording(), ag.is_training())
    with ag.train_mode():
        out["train"] = ag.is_training()
    with ag.predict_mode():
        out["predict"] = ag.is_training()
    prev = ag.set_training(True)
    out["set_training"] = (prev, ag.is_training())
    ag.set_training(prev)
    return out


def test_autograd_matches_jax():
    _same(_grads, rtol=1e-5, atol=1e-6)


def _second_order(s, fn, x_np):
    x = s.array(x_np)
    x.attach_grad()
    with s.ag.record():
        y = fn(s.nd, x)
        dydx = s.ag.grad(y, x, create_graph=True, retain_graph=True)
        dydx.backward()
    return x.grad


@pytest.mark.parametrize("fn,x_np", [
    (lambda nd, x: nd.sin(x),
     np.random.RandomState(0).rand(3, 4).astype(np.float32) * 2),
    (lambda nd, x: nd.log(x),
     np.random.RandomState(1).rand(3, 4).astype(np.float32) + 0.5),
    (lambda nd, x: nd.sigmoid(x),
     np.random.RandomState(2).randn(3, 4).astype(np.float32)),
    (lambda nd, x: x * x * x + 2.0 * (x * x),
     np.random.RandomState(3).randn(3).astype(np.float32)),
], ids=["sin", "log", "sigmoid", "polynomial"])
def test_second_order_gradients_match_jax(fn, x_np):
    _same(lambda s: {"d2": _second_order(s, fn, x_np)}, rtol=1e-4,
          atol=1e-5)


def _higher(s):
    ag = s.ag
    x_np = np.array([0.7, -0.3, 1.2], np.float32)
    x = s.array(x_np)
    x.attach_grad()
    with ag.record():
        y = x * x * x * x
        g1 = ag.grad(y, x, create_graph=True, retain_graph=True)
        g2 = ag.grad(g1, x, create_graph=True, retain_graph=True)
        g2.backward()
    out = {"third": x.grad}
    z = s.array([2.0])
    z.attach_grad()
    with ag.record():
        g = ag.grad(z * z, z)
    out["first"] = g
    p = s.array([1.0, 2.0])
    p.attach_grad()
    with ag.record():
        q = (p * p * p).sum()
        (gp,) = ag.grad(q, [p], create_graph=True, retain_graph=True)
        (gp * gp).sum().backward()
    out["product"] = p.grad
    return out


def test_higher_order_gradients_match_jax():
    _same(_higher, rtol=1e-4, atol=1e-5)


def test_get_symbol_raises_as_the_reference():
    with pytest.raises(NotImplementedError):
        tag.get_symbol(tnd.zeros((1,), ctx="cpu"))


# ---------------------------------------------------------------- AMP --
@pytest.mark.parametrize("method", ["sum", "mean"])
def test_f16_reduction_method_under_amp_matches_jax(method):
    """An f16 NDArray's reduction method under amp.init(float16) goes
    through the op chokepoint and its cast, as the reference's method
    does (the port's tensors alone would stay f16)."""
    data = (np.random.RandomState(4).rand(64, 33) * 8).astype(np.float16)
    mx.amp.init(target_dtype="float16")
    try:
        want = getattr(mx.nd.array(data, dtype="float16"), method)()
        want_ax = getattr(mx.nd.array(data, dtype="float16"), method)(
            axis=1)
    finally:
        mx.amp.uninit()
    tmx.amp.init(target_dtype="float16")
    try:
        x = tnd.array(data, ctx="cpu", dtype="float16")
        got, got_ax = getattr(x, method)(), getattr(x, method)(axis=1)
    finally:
        tmx.amp.uninit()
    for g, w in ((got, want), (got_ax, want_ax)):
        assert np.dtype(g.dtype) == np.dtype(w.dtype)
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=1e-5)


# ------------------------------------------------------------ boundary --
def test_torch_functions_take_an_ndarray():
    a = tnd.array(Y, ctx="cpu")
    w = torch.from_numpy(X[:2])
    assert torch.equal(a, torch.from_numpy(Y))
    out = F.linear(a, w)
    assert isinstance(out, torch.Tensor)
    torch.testing.assert_close(out, torch.from_numpy(Y) @ w.t())
    assert torch.is_tensor(torch.add(a, 1.0))


def test_gluon_block_on_an_ndarray_returns_what_it_does_on_the_tensor():
    from mxnet_tpu_torch.gluon import nn
    net = nn.Dense(5, in_units=4, prefix="ndarray_boundary_")
    net.initialize(device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(Y)
    want = net(x)
    got = net(tnd.array(Y, ctx="cpu"))
    assert isinstance(got, torch.Tensor)
    assert torch.equal(got, want)

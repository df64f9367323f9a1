"""PyTorch port, ``nd.contrib``'s control flow
(``mxnet_tpu_torch/ndarray/contrib.py``): the tests of
tests/test_control_flow.py, each run on the port and on the JAX
package's ``nd.contrib`` with the same numpy inputs and held against it
(rtol 1e-5 forward, rtol 1e-4 / atol 1e-5 for gradients), beside the
original oracles: ``foreach`` against the unrolled loop, ``while_loop``
(a fixed trip of masked steps, the rows after the exit zero) against a
Python loop and its gradient against a numeric one, ``cond`` both ways
with its gradient.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu.autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd

torch.set_num_threads(2)
PKGS = {"port": (tnd, tag, {"ctx": "cpu"}), "jax": (jnd, jag, {})}
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _foreach_grads(pkg, data_np, init_np):
    nd, ag, kw = PKGS[pkg]

    def body(x, state):
        s = state[0] * 0.9 + x * x
        return s * 2.0, [s]
    data, init = nd.array(data_np, **kw), nd.array(init_np, **kw)
    data.attach_grad()
    init.attach_grad()
    with ag.record():
        outs, final = nd.contrib.foreach(body, data, [init])
        loss = outs.sum() + final[0].sum()
    loss.backward()
    data2, init2 = nd.array(data_np, **kw), nd.array(init_np, **kw)
    data2.attach_grad()
    init2.attach_grad()
    with ag.record():
        s, tot = init2, None
        for t in range(data_np.shape[0]):
            o, (s,) = body(data2[t], [s])
            tot = o.sum() if tot is None else tot + o.sum()
        loss2 = tot + s.sum()
    loss2.backward()
    return [a.asnumpy() for a in (outs, loss, loss2, data.grad, init.grad,
                                  data2.grad, init2.grad)]


def test_foreach_matches_unrolled_forward_and_grad():
    rng = np.random.RandomState(0)
    data_np = rng.randn(5, 3).astype(np.float32)
    init_np = rng.randn(3).astype(np.float32)
    got = _foreach_grads("port", data_np, init_np)
    want = _foreach_grads("jax", data_np, init_np)
    outs, loss, loss2, gd, gi, gd2, gi2 = got
    assert outs.shape == (5, 3)
    np.testing.assert_allclose(loss, loss2, rtol=1e-5)
    np.testing.assert_allclose(gd, gd2, **GRAD)
    np.testing.assert_allclose(gi, gi2, **GRAD)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **(FWD if k < 3 else GRAD))


def _multi(pkg, a_np, b_np):
    nd, _, kw = PKGS[pkg]
    a, b = nd.array(a_np, **kw), nd.array(b_np, **kw)
    s0 = nd.array(np.zeros(2, np.float32), **kw)

    def body(xs, states):
        x, y = xs
        s = states[0] + x * y
        return [x + y, s * 1.0], [s]
    (o1, o2), [fs] = nd.contrib.foreach(body, [a, b], [s0])
    return o1.asnumpy(), o2.asnumpy(), fs.asnumpy()


def test_foreach_multiple_data_and_outputs():
    rng = np.random.RandomState(1)
    a = rng.randn(4, 2).astype(np.float32)
    b = rng.randn(4, 2).astype(np.float32)
    o1, o2, fs = _multi("port", a, b)
    np.testing.assert_allclose(o1, a + b, rtol=1e-6)
    np.testing.assert_allclose(o2, np.cumsum(a * b, axis=0), rtol=1e-5)
    np.testing.assert_allclose(fs, (a * b).sum(0), rtol=1e-5)
    for g, w in zip((o1, o2, fs), _multi("jax", a, b)):
        np.testing.assert_allclose(g, w, **FWD)


def _while(pkg):
    nd, _, kw = PKGS[pkg]

    def cond_fn(i, s):
        return i < 5

    def func(i, s):
        return (s + i), (i + 1, s + i)
    i0 = nd.array(np.array(0.0, np.float32), **kw)
    s0 = nd.array(np.array(1.0, np.float32), **kw)
    outs, (fi, fs) = nd.contrib.while_loop(cond_fn, func, [i0, s0],
                                           max_iterations=8)
    return outs.asnumpy(), fi.asnumpy(), fs.asnumpy()


def test_while_loop_matches_python_loop():
    o, fi, fs = _while("port")
    i, s, ys = 0.0, 1.0, []
    while i < 5:
        ys.append(s + i)
        i, s = i + 1, s + i
    assert float(fi) == i and float(fs) == s
    assert o.shape == (8,)
    np.testing.assert_allclose(o[:len(ys)], ys, rtol=1e-6)
    np.testing.assert_allclose(o[len(ys):], 0.0)
    for g, w in zip((o, fi, fs), _while("jax")):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **FWD)


def _while_grad(pkg):
    nd, ag, kw = PKGS[pkg]
    x0 = nd.array(np.array([2.0, 3.0], np.float32), **kw)
    x0.attach_grad()

    def cond_fn(x, t):
        return t < 3

    def func(x, t):
        return x * 0.0, (x * x * 0.1 + x, t + 1)
    with ag.record():
        _, (xf, _) = nd.contrib.while_loop(
            cond_fn, func, [x0, nd.array(np.array(0.0, np.float32), **kw)],
            max_iterations=5)
        loss = xf.sum()
    loss.backward()
    return x0.grad.asnumpy()


def test_while_loop_grads():
    got = _while_grad("port")

    def f(v):
        x = v.copy()
        for _ in range(3):
            x = x * x * 0.1 + x
        return x.sum()
    eps, base, num = 1e-3, np.array([2.0, 3.0]), np.zeros(2)
    for j in range(2):
        p, m = base.copy(), base.copy()
        p[j] += eps
        m[j] -= eps
        num[j] = (f(p) - f(m)) / (2 * eps)
    np.testing.assert_allclose(got, num, rtol=1e-3)
    np.testing.assert_allclose(got, _while_grad("jax"), **GRAD)


def _cond(pkg, branch):
    nd, ag, kw = PKGS[pkg]
    x = nd.array(np.array([1.0, -2.0], np.float32), **kw)
    x.attach_grad()
    flag = nd.array(np.array(1.0 if branch else -1.0, np.float32), **kw)
    with ag.record():
        out = nd.contrib.cond(lambda a, f: (f > 0), lambda a, f: a * 3.0,
                              lambda a, f: a * a, [x, flag])
        loss = out.sum()
    loss.backward()
    return out.asnumpy(), x.grad.asnumpy()


@pytest.mark.parametrize("branch", [True, False])
def test_cond_forward_and_grad(branch):
    out, g = _cond("port", branch)
    if branch:
        np.testing.assert_allclose(out, [3.0, -6.0])
        np.testing.assert_allclose(g, [3.0, 3.0])
    else:
        np.testing.assert_allclose(out, [1.0, 4.0])
        np.testing.assert_allclose(g, [2.0, -4.0])
    jout, jg = _cond("jax", branch)
    np.testing.assert_allclose(out, jout, **FWD)
    np.testing.assert_allclose(g, jg, **GRAD)


def test_foreach_inside_hybridized_block():
    """``foreach`` inside a gluon block's forward: the hybridized block
    gives the eager block's outputs, and both the numpy recurrence over
    the block's own weights."""
    from mxnet_tpu_torch.gluon import nn

    class ScanNet(nn.HybridSequential):
        def __init__(self):
            super().__init__()
            self.proj = nn.Dense(4, flatten=False, in_units=3)

        def forward(self, x):
            h = self.proj(x)
            ht = tnd.NDArray(h).transpose((1, 0, 2))

            def body(xt, states):
                s = states[0] + xt.tanh()
                return s, [s]
            outs, _ = tnd.contrib.foreach(
                body, ht, [tnd.zeros((h.shape[0], 4), ctx="cpu")])
            return outs[-1]._data

    net = ScanNet()
    net.initialize(device="cpu")
    x_np = np.random.RandomState(0).randn(2, 6, 3).astype(np.float32)
    x = tnd.array(x_np, ctx="cpu")
    with tag.pause():
        eager = np.asarray(net(x).detach())
        net.hybridize()
        hyb = np.asarray(net(x).detach())
        hyb2 = np.asarray(net(x).detach())
    w = net.proj.weight.data().detach().numpy()
    b = net.proj.bias.data().detach().numpy()
    want = np.tanh(x_np @ w.T + b).sum(axis=1)
    np.testing.assert_allclose(eager, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hyb, eager, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hyb2, eager, rtol=1e-5, atol=1e-6)


def test_foreach_stateless():
    for pkg in PKGS:
        nd, _, kw = PKGS[pkg]
        data = nd.array(np.arange(6.0).reshape(3, 2).astype(np.float32),
                        **kw)
        outs, states = nd.contrib.foreach(lambda x, s: (x * 2, s), data,
                                          None)
        np.testing.assert_allclose(outs.asnumpy(),
                                   np.arange(6.0).reshape(3, 2) * 2)
        assert states is None


def test_while_loop_reads_nothing_on_the_host(monkeypatch):
    """The fixed trip never reads the condition on the host: every host
    read of a tensor raises, and the loop still runs (so a capture can
    take it)."""
    i0 = tnd.array(np.array(0.0, np.float32), ctx="cpu")
    s0 = tnd.array(np.array(1.0, np.float32), ctx="cpu")

    def boom(*a, **k):
        raise AssertionError("host read")
    for name in ("item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    outs, (fi, _) = tnd.contrib.while_loop(
        lambda i, s: i < 3, lambda i, s: (s * i, (i + 1, s + i)), [i0, s0],
        max_iterations=6)
    monkeypatch.undo()
    assert outs.shape == (6,) and float(fi.asnumpy()) == 3.0
    assert not outs.asnumpy()[3:].any()

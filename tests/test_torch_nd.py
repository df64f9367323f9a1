"""PyTorch port, the op front end: ``mxnet_tpu_torch.ops.registry``,
``ops.invoke.apply_op`` and the generated ``nd`` namespace against the
JAX package's on the same numpy inputs.

Tolerances: ``ATT_RTOL, ATT_ATOL = 2e-5, 2e-6`` for paged attention (that
of tests/test_ragged_attention.py: f32 sums in another order);
``FLASH_TOL = 1e-5`` for the attention op (the port's flash twins against
the JAX flash kernel in interpret mode, as in
tests/test_torch_flash_attention.py). Everything else is exact.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.ndarray.register import make_op_func as j_make  # noqa: E402
from mxnet_tpu.ops import registry as jreg  # noqa: E402
from mxnet_tpu_torch import autograd as ag  # noqa: E402
from mxnet_tpu_torch import nd  # noqa: E402
from mxnet_tpu_torch.ndarray.register import make_op_func  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402
from mxnet_tpu_torch.ops.invoke import apply_op  # noqa: E402

torch.set_num_threads(2)

ATT_RTOL, ATT_ATOL = 2e-5, 2e-6
FLASH_TOL = 1e-5
BS, H, D = 8, 2, 16


@pytest.fixture
def scratch_ops():
    """Names registered by a test, removed from both registries after."""
    names = []
    yield names
    for n in names:
        treg._REGISTRY.pop(n, None)
        jreg._REGISTRY.pop(n, None)


def test_register_refuses_duplicates_and_get_names_the_op(scratch_ops):
    scratch_ops.append("_nd_test_dup")
    treg.register("_nd_test_dup")(lambda x: x)
    with pytest.raises(ValueError, match="_nd_test_dup"):
        treg.register("_nd_test_dup")(lambda x: x)
    with pytest.raises(KeyError, match="_nd_test_missing"):
        treg.get("_nd_test_missing")
    assert "_nd_test_dup" in treg.list_ops()


def test_alias_points_at_the_same_op(scratch_ops):
    scratch_ops += ["_nd_test_base", "_nd_test_alias"]
    treg.register("_nd_test_base")(lambda x: x)
    treg.alias("_nd_test_alias", "_nd_test_base")
    assert treg.get("_nd_test_alias") is treg.get("_nd_test_base")


def test_ported_ops_are_registered_like_the_jax_ones():
    for name in ("ragged_paged_attention", "scaled_dot_product_attention"):
        mine, theirs = treg.get(name), jreg.get(name)
        assert mine.differentiable == theirs.differentiable
        assert callable(getattr(nd, name))


@pytest.mark.parametrize("extra,kw", [((), {}), ((3.0,), {}),
                                      ((3.0, 5.0), {}),
                                      ((3.0,), {"beta": -1.0})])
def test_positional_arguments_map_like_jax(scratch_ops, extra, kw):
    """Leading arrays are inputs, further positionals fill the impl's
    parameters in order (also keyword-only ones), as in the JAX
    package."""
    name = "_nd_test_affine"
    scratch_ops.append(name)

    def t_impl(x, y, alpha=1.0, *, beta=2.0):
        return x * alpha + y * beta

    def j_impl(x, y, alpha=1.0, *, beta=2.0):
        return x * alpha + y * beta
    treg.register(name)(t_impl)
    jreg.register(name)(j_impl)
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    y = np.ones((2, 3), np.float32)
    got = make_op_func(treg.get(name))(torch.from_numpy(x), y, *extra,
                                       **kw)
    want = j_make(jreg.get(name))(mx.nd.array(x), mx.nd.array(y), *extra,
                                  **kw)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def _paged(seed, chunk):
    rng = np.random.RandomState(seed)
    kv = np.array([5, BS, 2 * BS + 3], np.int32)
    kp = rng.randn(12, BS, H, D).astype(np.float32)
    vp = rng.randn(12, BS, H, D).astype(np.float32)
    tables = np.array([[4, 0, 0], [7, 0, 0], [2, 9, 5]], np.int32)
    q = rng.randn(*((3, 4, H, D) if chunk else (3, H, D))).astype(
        np.float32)
    kw = {"q_lens": np.array([4, 2, 3], np.int32)} if chunk else {}
    return (q, kp, vp, tables, kv), kw


@pytest.mark.parametrize("chunk", [False, True], ids=["decode", "chunk"])
def test_nd_ragged_paged_attention_matches_jax(chunk):
    arrays, kw = _paged(1, chunk)
    want = mx.nd.ragged_paged_attention(
        *(mx.nd.array(a) for a in arrays), **kw).asnumpy()
    # the first input a CPU tensor, the rest numpy: moved to its device
    got = nd.ragged_paged_attention(torch.from_numpy(arrays[0]),
                                    *arrays[1:], **kw)
    assert isinstance(got, nd.NDArray) and got.context.device_type == "cpu"
    if chunk:
        for i, n in enumerate(kw["q_lens"]):
            np.testing.assert_allclose(got[i, :n].asnumpy(), want[i, :n],
                                       rtol=ATT_RTOL, atol=ATT_ATOL)
    else:
        np.testing.assert_allclose(got.asnumpy(), want, rtol=ATT_RTOL,
                                   atol=ATT_ATOL)


def test_nd_scaled_dot_product_attention_matches_jax():
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(2, H, 24, D).astype(np.float32) for _ in range(3))
    bias = np.where(np.arange(24)[None, :] < np.array([[24], [17]]), 0.0,
                    -1e30).astype(np.float32)
    want = mx.nd.scaled_dot_product_attention(
        *(mx.nd.array(a) for a in (q, k, v, bias))).asnumpy()
    got = nd.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v, bias)))
    np.testing.assert_allclose(got.asnumpy(), want, atol=FLASH_TOL,
                               rtol=0)


def test_nd_array_defaults_to_the_card(monkeypatch):
    for src in ([1, 2], np.arange(3, dtype=np.int32), np.ones(2)):
        got = nd.array(src, ctx="cpu")
        want = mx.nd.array(src)
        assert got.context.device_type == "cpu"
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert nd.zeros((2, 3), ctx=torch.device("cpu")).sum() == 0
    assert nd.ones(4, ctx="cpu", dtype="int32").dtype == np.int32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: nd.array([1.0]), lambda: nd.zeros(2),
                 lambda: nd.ones(2),
                 lambda: nd.ragged_paged_attention(*_paged(0, False)[0])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    nd.waitall()


def test_non_differentiable_op_stays_off_the_tape():
    arrays, _ = _paged(3, False)
    q = torch.from_numpy(arrays[0]).requires_grad_()
    rest = [torch.from_numpy(a) for a in arrays[1:]]
    with ag.record():
        out = nd.ragged_paged_attention(q, *rest)
        att = nd.scaled_dot_product_attention(q[None], q[None], q[None])
    assert out._data.grad_fn is None and not out._data.requires_grad
    assert att._data.grad_fn is not None


def test_out_writes_the_given_tensor():
    arrays, kw = _paged(4, True)
    t = [torch.from_numpy(a) for a in arrays]
    buf = torch.zeros(arrays[0].shape)
    res = nd.ragged_paged_attention(*t, out=buf, **kw)
    assert res is buf
    assert torch.equal(buf, nd.ragged_paged_attention(*t, **kw))


def _feature_op(flag):
    """A scratch op of one invocation feature (the same impl serves both
    packages): a variadic mutates op writing its first input, an op of a
    random key or of the training flag, a variadic op."""
    if flag == "mutates":
        return dict(variadic=True, mutates=(0,)), \
            (lambda xs: xs[0] + xs[1])
    if flag == "needs_rng":
        # the key's bits are not compared (the packages' streams differ),
        # only that the op got one
        return dict(needs_rng=True), \
            (lambda x, rng=None: x + float(rng is not None))
    if flag == "needs_train":
        return dict(needs_train=True), \
            (lambda x, _training=False: x * (2.0 if _training else 3.0))
    return dict(variadic=True), (lambda xs: xs[0] * xs[1] - xs[2])


@pytest.mark.parametrize("flag", ["mutates", "needs_rng", "needs_train",
                                  "variadic"])
def test_invoke_features_work_as_jax(scratch_ops, flag):
    """Each invocation feature of the registry runs through apply_op as
    through the JAX package's: the same result (under record(), so the
    training flag is set), and a mutates op writes its input in place in
    both."""
    from mxnet_tpu.ops.invoke import apply_op as japply_op
    name = f"_nd_test_{flag}"
    scratch_ops.append(name)
    kw, impl = _feature_op(flag)
    treg.register(name, **kw)(impl)
    jreg.register(name, **kw)(impl)
    arrays = [np.arange(4, dtype=np.float32) + k for k in range(3)]
    n_in = 2 if flag == "mutates" else 3 if flag == "variadic" else 1
    tx = [nd.array(a, ctx="cpu") for a in arrays[:n_in]]
    jx = [mx.nd.array(a) for a in arrays[:n_in]]
    with ag.record(), mx.autograd.record():
        got = apply_op(name, tx)
        want = japply_op(name, jx)
    np.testing.assert_array_equal(got.detach().numpy(), want.asnumpy())
    if flag == "mutates":
        np.testing.assert_array_equal(tx[0].asnumpy(), jx[0].asnumpy())
        np.testing.assert_array_equal(tx[0].asnumpy(),
                                      arrays[0] + arrays[1])


def test_sparse_embedding_gradients_still_raise():
    """Under ``record()`` the sparse lookups no longer raise: the weight's
    gradient is a COO tensor of the looked-up ids in lookup order."""
    weight = torch.ones(4, 3, requires_grad=True)
    ids = torch.tensor([0.0, 2.0])
    assert apply_op("_contrib_SparseEmbedding", [ids, weight]).shape == (2, 3)
    for name, params in (("_contrib_SparseEmbedding", None),
                         ("Embedding", {"sparse_grad": True})):
        with ag.record():
            out = apply_op(name, [ids, weight], params)
        (g,) = torch.autograd.grad(out.sum(), [weight])
        assert g.is_sparse and g._indices()[0].tolist() == [0, 2]
        assert torch.equal(g._values(), torch.ones(2, 3))

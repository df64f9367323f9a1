"""PyTorch port: ``sign``, ``cbrt`` and ``relu`` keep the JAX ops' bits on
NaN, ±0 and ±inf; ``topk`` breaks ties as ``lax.top_k`` does; the
package root resolves the reference's names.

Bits, not values: a NaN against a NaN and -0 against +0 are compared as
raw bytes (``jnp.sign`` keeps NaN and the sign of zero, ``torch.sign``
did not; ``jnp.maximum(x, 0)`` gives +0 for -0, ``torch.relu`` did not).
``topk``'s indices and values are held exactly: ``lax.top_k`` orders by
IEEE totalOrder (-NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN) and
puts the lower index first among equal keys, for ``is_ascend`` (the top
of ``-x``) too.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.ops.registry import get as jget

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ops.registry import get as tget

torch.set_num_threads(2)

SPECIALS = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, -1.0, 2.0],
                    np.float32)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).tobytes()


@pytest.mark.parametrize("name,kw", [
    ("sign", {}), ("cbrt", {}), ("relu", {}), ("_npx_relu", {}),
    ("Activation", {"act_type": "relu"})])
def test_op_keeps_the_jax_ops_bits(name, kw):
    want = jget(name).impl(jnp.asarray(SPECIALS), **kw)
    got = tget(name).impl(torch.from_numpy(SPECIALS.copy()), **kw)
    assert _bits(got) == _bits(want), (name, np.asarray(got),
                                       np.asarray(want))


def test_gluon_relu_and_nd_sign_keep_the_bits():
    x = torch.from_numpy(SPECIALS.copy())
    want_relu = np.maximum(SPECIALS, np.float32(0))
    want_relu[1] = 0.0                     # numpy keeps -0; jnp gives +0
    with tmx.autograd.pause():
        got = tnn.Activation("relu", prefix="act_")(x)
    assert _bits(got) == _bits(jnd.relu(jnd.array(SPECIALS)).asnumpy())
    assert _bits(got) == _bits(want_relu)
    assert _bits(tnd.sign(tnd.array(SPECIALS, ctx="cpu")).asnumpy()) == \
        _bits(jnd.sign(jnd.array(SPECIALS)).asnumpy())
    # cbrt(-0) is -0
    assert np.signbit(tnd.cbrt(tnd.array(SPECIALS, ctx="cpu"))
                      .asnumpy()[1])


TOPK_CASES = [
    (np.array([1, 1, 1, 1, 0, 1, 1, 1], np.float32), 3),
    (np.zeros(64, np.float32), 3),
    (SPECIALS, 7),
    (np.array([0.0, -0.0, 0.0, -0.0, 1.0, -1.0], np.float32), 4),
    (np.random.RandomState(0).randint(0, 3, (3, 7)).astype(np.float32), 4),
]


@pytest.mark.parametrize("case", range(len(TOPK_CASES)))
@pytest.mark.parametrize("is_ascend", [False, True])
@pytest.mark.parametrize("ret_typ", ["value", "indices", "both"])
def test_topk_breaks_ties_as_lax_top_k(case, is_ascend, ret_typ):
    x, k = TOPK_CASES[case]
    kw = dict(k=k, is_ascend=is_ascend, ret_typ=ret_typ)
    want = jnd.topk(jnd.array(x), **kw)
    got = tnd.topk(tnd.array(x, ctx="cpu"), **kw)
    want = want if isinstance(want, (list, tuple)) else [want]
    got = got if isinstance(got, (list, tuple)) else [got]
    for g, w in zip(got, want, strict=True):
        assert _bits(g.asnumpy()) == _bits(w.asnumpy())


def test_topk_named_cases_and_axes():
    ties = tnd.array(np.array([1, 1, 1, 1, 0, 1, 1, 1], np.float32),
                     ctx="cpu")
    assert tnd.topk(ties, k=3).asnumpy().tolist() == [0, 1, 2]
    zeros = tnd.array(np.zeros(64, np.float32), ctx="cpu")
    for asc in (False, True):
        assert tnd.topk(zeros, k=3, is_ascend=asc).asnumpy().tolist() == \
            [0, 1, 2]
    x = np.random.RandomState(1).randint(0, 2, (4, 5, 6)).astype(np.float32)
    for axis in (0, 1, 2):
        np.testing.assert_array_equal(
            tnd.topk(tnd.array(x, ctx="cpu"), axis=axis, k=2).asnumpy(),
            jnd.topk(jnd.array(x), axis=axis, k=2).asnumpy())
    for mod in (jnd, tnd):
        with pytest.raises(NotImplementedError):
            arr = mod.array(x) if mod is jnd else mod.array(x, ctx="cpu")
            mod.topk(arr, k=2, ret_typ="mask")


# the reference's lazy names the port has (mxnet_tpu/__init__.py
# _LAZY_MODULES, _ALIAS), and the eager ones the issue names
PORTED = sorted(n for n in jmx._LAZY_MODULES if n in tmx._LAZY_MODULES)


def test_root_resolves_the_reference_names_in_both_packages():
    assert len(PORTED) == 18 and "gluon" in PORTED and "jit" in PORTED
    assert {"metric", "profiler", "callback", "monitor"} <= set(PORTED)
    assert "kvstore" in PORTED and tmx.kv is tmx.kvstore
    for name in PORTED + ["NDArray", "MXNetError", "waitall"]:
        assert getattr(jmx, name) is not None
        assert getattr(tmx, name) is not None, name
    assert tmx.gluon.nn.Conv2D is not None
    assert issubclass(tmx.MXNetError, RuntimeError)
    assert isinstance(tnd.array(np.ones(2), ctx="cpu"), tmx.NDArray)
    tmx.waitall()


@pytest.mark.parametrize("name", sorted(
    n for n in list(jmx._LAZY_MODULES) + list(jmx._ALIAS)
    if jmx._ALIAS.get(n, n) not in tmx._LAZY_MODULES))
def test_unported_names_raise_naming_their_roadmap_item(name):
    target = tmx._ALIAS.get(name, name)
    with pytest.raises(AttributeError, match=r"ROADMAP\.md §1 item 1"):
        getattr(tmx, name)
    assert target in tmx._NOT_PORTED


def test_fresh_interpreter_resolves_the_root_lazily():
    code = (
        "import sys\n"
        "import mxnet_tpu_torch as mx\n"
        "assert not any(m.startswith('mxnet_tpu_torch.gluon') "
        "for m in sys.modules), 'gluon loaded at import'\n"
        "mx.gluon, mx.optimizer, mx.initializer, mx.NDArray, "
        "mx.MXNetError, mx.waitall\n"
        "assert 'mxnet_tpu_torch.gluon' in sys.modules\n"
        "mx.metric.Accuracy, mx.profiler.dumps, "
        "mx.gluon.contrib.estimator.Estimator\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'mxnet_tpu.')) "
        "for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

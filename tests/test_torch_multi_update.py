"""PyTorch port, the multi-tensor update tail (``mxnet_tpu_torch/ops/
extra.py``) and the update ops of ``mxnet_tpu/ops/extra.py`` it adds to
the update kernel's rules (``mp_nag_mom_update``, ``_mp_adamw_update``,
``ftml_update``), against the JAX ops on the same numpy inputs.

Each functional op returns the JAX op's outputs (count, order, dtypes)
and leaves its inputs as they were; ``preloaded_*`` take ``lrs``/``wds``
as arrays; ``multi_lars`` keeps the learning rate where a norm is zero.
On the CPU the ops run the kernel's twins (the card's bits are held
against the twins in tests/test_torch_cuda.py and chip_smoke.py).

Tolerances against the JAX ops: f32 results rtol 1e-6 / atol 1e-7 (one
rounding apart at most: the same formulas, f32 scalars rounded once on
either side); 16-bit weights within one ulp of their dtype plus the f32
tolerance (the mp ops here cast the gradient to f32 before scaling it,
as the reference's MXNet kernels; the JAX ops scale it in 16 bits, so
the f32 master differs by up to ``lr`` times the 16-bit rounding of the
scaled gradient: :data:`MP_ATOL`). The measured maxima are in PERF.md.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu_torch import nd as tnd  # noqa: E402
from mxnet_tpu_torch.ops import optimizer_ops as tops  # noqa: E402

torch.set_num_threads(2)
RTOL, ATOL = 1e-6, 1e-7
SHAPES = ((3, 5), (7,), (2, 2, 3))
LRS, WDS = (0.1, 0.05, 0.2), (0.0, 0.01, 0.1)
# lr (at most 0.2) times bf16's relative step (2^-8) on a scaled gradient
# of at most 2: the f32 master's difference from the JAX op's
MP_ATOL = 0.2 * 2 ** -8 * 2


def _data(seed, wdtype=np.float32):
    rng = np.random.RandomState(seed)
    out = []
    for shape in SHAPES:
        w = rng.randn(*shape).astype(np.float32)
        g = (rng.randn(*shape) * 2).astype(np.float32)
        mom = (rng.randn(*shape) * 0.1).astype(np.float32)
        var = rng.uniform(0.1, 0.5, shape).astype(np.float32)
        out.append((w, g, mom, var))
    return out


def _jax(a, dtype):
    return mx.nd.array(a, dtype=dtype)


def _port(a, dtype):
    t = torch.from_numpy(np.array(a, np.float32))     # its own buffer
    return tnd.array(t.to(getattr(torch, dtype)), ctx="cpu")


def _arrays(side, data, layout, wdtype):
    """The op's flat input list: per weight the ``layout`` of (w16/w,
    g, mom, var, w32)."""
    make = _jax if side == "jax" else _port
    out = []
    for w, g, mom, var in data:
        vals = {"w": (w, wdtype), "g": (g, wdtype), "m": (mom, "float32"),
                "v": (var, "float32"), "w32": (w, "float32")}
        out += [make(*vals[k]) for k in layout]
    return out


def _np(x):
    return x.asnumpy().astype(np.float32)


def _name(dtype):
    return "bfloat16" if dtype == torch.bfloat16 else np.dtype(dtype).name


def _compare(got, want, wdtype):
    assert len(got) == len(want)
    worst = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _name(g.dtype) == _name(w.dtype)
        a, b = _np(g), _np(w)
        low = _name(g.dtype) in ("float16", "bfloat16")
        ulp = 2 ** -7 if _name(g.dtype) == "bfloat16" else 2 ** -10
        rtol = ulp if low else RTOL
        atol = MP_ATOL if wdtype != "float32" else ATOL
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


MULTI = [
    # op, layout, wdtype, extra kwargs
    ("multi_sgd_update", "wg", "float32", {}),
    ("multi_sgd_mom_update", ("w", "g", "m"), "float32", {"momentum": 0.9}),
    ("multi_mp_sgd_update", ("w", "g", "w32"), "bfloat16", {}),
    ("multi_mp_sgd_mom_update", ("w", "g", "m", "w32"), "float16",
     {"momentum": 0.9}),
]


@pytest.mark.parametrize("preloaded", [False, True],
                         ids=["host_lists", "preloaded"])
@pytest.mark.parametrize("op,layout,wdtype,kw", MULTI,
                         ids=[m[0] for m in MULTI])
def test_multi_sgd_family_matches_jax(op, layout, wdtype, kw, preloaded):
    data = _data(1)
    kw = dict(kw, rescale_grad=0.75, clip_gradient=1.5)
    jx = _arrays("jax", data, layout, wdtype)
    tx = _arrays("port", data, layout, wdtype)
    before = [t.asnumpy().copy() for t in tx]
    if preloaded:
        lrs, wds = np.array(LRS, np.float32), np.array(WDS, np.float32)
        want = getattr(mx.nd, "preloaded_" + op)(
            *jx, mx.nd.array(lrs), mx.nd.array(wds), **kw)
        got = getattr(tnd, "preloaded_" + op)(
            *tx, tnd.array(lrs, ctx="cpu"), tnd.array(wds, ctx="cpu"), **kw)
    else:
        want = getattr(mx.nd, op)(*jx, num_weights=len(data), lrs=LRS,
                                  wds=WDS, **kw)
        got = getattr(tnd, op)(*tx, num_weights=len(data), lrs=LRS,
                               wds=WDS, **kw)
    _compare(got, want, wdtype)
    for t, b in zip(tx, before):          # functional: inputs unchanged
        np.testing.assert_array_equal(t.asnumpy(), b)


@pytest.mark.parametrize("mp", [False, True], ids=["f32", "mp_bf16"])
def test_multi_adamw_matches_jax(mp):
    data = _data(2)
    layout = ("w", "g", "m", "v") + (("w32",) if mp else ())
    wdtype = "bfloat16" if mp else "float32"
    op = "_multi_mp_adamw_update" if mp else "_multi_adamw_update"
    kw = dict(lrs=LRS, wds=WDS, etas=(1.0, 0.5, 2.0), beta1=0.8,
              beta2=0.99, epsilon=1e-6, clip_gradient=1.0)
    rescale = np.array([0.5], np.float32)
    jx = _arrays("jax", data, layout, wdtype) + [mx.nd.array(rescale)]
    tx = _arrays("port", data, layout, wdtype) + [tnd.array(rescale,
                                                            ctx="cpu")]
    before = [t.asnumpy().copy() for t in tx]
    want = getattr(mx.nd, op)(*jx, **kw)
    got = getattr(tnd, op)(*tx, **kw)
    _compare(got, want, wdtype)
    for t, b in zip(tx, before):
        np.testing.assert_array_equal(t.asnumpy(), b)


def test_multi_adamw_on_16_bit_weights_goes_through_f32():
    """``_multi_adamw_update`` on bf16 weights without masters: the JAX
    op computes in f32 and casts back; so does the port (the mp rule
    over an f32 copy)."""
    data = _data(3)
    rescale = np.array([1.0], np.float32)
    jx = _arrays("jax", data, "wgmv", "bfloat16") + [mx.nd.array(rescale)]
    tx = _arrays("port", data, "wgmv", "bfloat16") + [
        tnd.array(rescale, ctx="cpu")]
    kw = dict(lrs=LRS, wds=WDS, etas=(1.0, 1.0, 1.0))
    _compare(tnd._multi_adamw_update(*tx, **kw),
             mx.nd._multi_adamw_update(*jx, **kw), "bfloat16")


def test_reductions_match_jax():
    rng = np.random.RandomState(4)
    arrays = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jx = [mx.nd.array(a) for a in arrays]
    tx = [tnd.array(a, ctx="cpu") for a in arrays]
    for got, want in zip(tnd.multi_sum_sq(*tx, num_arrays=3),
                         mx.nd.multi_sum_sq(*jx, num_arrays=3)):
        assert got.shape == want.shape == (1,)
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6)
    for ok in (True, False):
        if not ok:
            arrays[1][0] = np.inf
            jx[1] = mx.nd.array(arrays[1])
            tx[1] = tnd.array(arrays[1], ctx="cpu")
        got = tnd.multi_all_finite(*tx, num_arrays=3)
        want = mx.nd.multi_all_finite(*jx, num_arrays=3)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
        np.testing.assert_array_equal(tnd.all_finite(tx[1]).asnumpy(),
                                      mx.nd.all_finite(jx[1]).asnumpy())
    nan = tnd.array(np.array([1.0, np.nan], np.float32), ctx="cpu")
    assert float(tnd.multi_all_finite(nan, tx[0]).asscalar()) == 0.0
    zeros = tnd.reset_arrays(*tx, num_arrays=3)
    assert all(float(abs(z).sum().asscalar()) == 0.0 for z in zeros)
    assert [z.shape for z in zeros] == [t.shape for t in tx]


def test_multi_lars_matches_jax_and_keeps_lr_at_zero_norms():
    lrs = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    w2 = np.array([4.0, 0.0, 9.0, 1.0], np.float32)
    g2 = np.array([1.0, 1.0, 0.0, 0.25], np.float32)
    wds = np.array([0.01, 0.0, 0.1, 0.5], np.float32)
    kw = dict(eta=0.02, eps=1e-8, rescale_grad=0.5)
    want = mx.nd.multi_lars(*(mx.nd.array(a) for a in (lrs, w2, g2, wds)),
                            **kw).asnumpy()
    got = tnd.multi_lars(*(tnd.array(a, ctx="cpu")
                           for a in (lrs, w2, g2, wds)), **kw).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(got[[1, 2]], lrs[[1, 2]])


ONE = [
    ("mp_nag_mom_update", ("w", "g", "m", "w32"), "bfloat16",
     dict(lr=0.1, momentum=0.9, wd=0.01, rescale_grad=0.75,
          clip_gradient=1.5)),
    ("_mp_adamw_update", ("w", "g", "m", "v", "w32"), "float16",
     dict(lr=0.05, beta1=0.8, beta2=0.99, epsilon=1e-6, wd=0.1, eta=0.5,
          rescale_grad=0.75, clip_gradient=1.0)),
    ("ftml_update", ("w", "g", "v", "v", "m"), "float32",
     dict(lr=0.05, beta1=0.6, beta2=0.999, epsilon=1e-8, t=3, wd=0.01,
          rescale_grad=0.75, clip_grad=1.5)),
]


@pytest.mark.parametrize("op,layout,wdtype,kw", ONE, ids=[o[0] for o in ONE])
def test_single_update_ops_match_jax_in_place(op, layout, wdtype, kw):
    """The three update ops of extra.py this slice adds to the kernel's
    rules write their weight and states in place, to the JAX op's
    results."""
    data = _data(5)[:1]
    jx = _arrays("jax", data, layout, wdtype)
    tx = _arrays("port", data, layout, wdtype)
    getattr(mx.nd, op)(*jx, **kw)
    getattr(tnd, op)(*tx, **kw)
    rule = tops.RULES[op]
    _compare([tx[m] for m in rule.mutates], [jx[m] for m in rule.mutates],
             wdtype)


def test_mp_adamw_rescale_array_matches_the_float():
    data = _data(6)[:1]
    layout = ("w", "g", "m", "v", "w32")
    a = _arrays("port", data, layout, "bfloat16")
    b = _arrays("port", data, layout, "bfloat16")
    kw = dict(lr=0.05, wd=0.01)
    tnd._mp_adamw_update(*a, rescale_grad=tnd.array([0.5], ctx="cpu"), **kw)
    tnd._mp_adamw_update(*b, rescale_grad=0.5, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.asnumpy(), y.asnumpy())


@pytest.mark.parametrize("op,layout,wdtype,n_out", [
    ("multi_sgd_mom_update", ("w", "g", "m"), "float32", 2),
    ("multi_mp_sgd_mom_update", ("w", "g", "m", "w32"), "bfloat16", 3),
    ("_multi_adamw_update", ("w", "g", "m", "v"), "bfloat16", 3)],
    ids=["f32", "mp", "adamw_16bit"])
def test_out_writes_the_targets_and_in_place_is_the_functional_result(
        op, layout, wdtype, n_out):
    """``out=`` fresh arrays: written there, the inputs unchanged;
    ``out=`` the op's own weights and states (the reference's in-place
    idiom): they end as the functional op's results."""
    data = _data(7)
    kw = dict(lrs=LRS, wds=WDS)
    if op.startswith("multi_"):
        kw.update(num_weights=len(data), momentum=0.9)
    else:
        kw.update(etas=(1.0, 1.0, 1.0))
    extra = [] if op.startswith("multi_") else [tnd.array([0.5], ctx="cpu")]
    tx = _arrays("port", data, layout, wdtype) + extra
    want = getattr(tnd, op)(*tx, **kw)
    fresh = [tnd.zeros(w.shape, ctx="cpu", dtype=w.dtype) for w in want]
    res = getattr(tnd, op)(*tx, out=fresh, **kw)
    assert res is fresh
    for f, w in zip(fresh, want):
        np.testing.assert_array_equal(f.asnumpy(), w.asnumpy())
    per = len(layout)
    written = [i for i, k in enumerate(layout) if k != "g"]
    own = [tx[k * per + i] for k in range(len(data)) for i in written]
    assert len(own) == len(want) and len(written) == n_out
    getattr(tnd, op)(*tx, out=own, **kw)
    for o, w in zip(own, want):
        np.testing.assert_array_equal(o.asnumpy(), w.asnumpy())

"""PyTorch port, the quantization ops (``mxnet_tpu_torch/ops/
quantization.py``'s registered ops) against the JAX package's on the
same numpy inputs: the cases of chip_smoke.py's ``TAIL_CORPUS`` (through
tests/test_torch_op_tail.py's ``run_tail_case``; int8 codes, int32
accumulators and ranges exact), the op tests of
tests/test_quantization.py run on both packages, the registered
``_contrib_quantized_matmul`` (the port's CUDA kernel's CPU twin)
against the JAX package's Pallas kernel in interpret mode within 1e-5,
and ``_contrib_calibrate_entropy`` exact. ``quantize_net`` waits with
item 14 of ROADMAP.md.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.contrib.quantization import optimal_threshold as jax_thresh
from mxnet_tpu.ops import quantization as jqz
from mxnet_tpu.ops.registry import _REGISTRY as JREG
from mxnet_tpu.serving.llm.quant import quantize_leaf as jax_quantize_leaf
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.contrib.quantization import optimal_threshold
from mxnet_tpu_torch.convert import tensor_from_numpy
from mxnet_tpu_torch.ops.registry import _REGISTRY as TREG

torch.set_num_threads(2)
_spec = importlib.util.spec_from_file_location(
    "_tail_main", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "test_torch_op_tail.py"))
_tail = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_tail)
_CASES, _IDS = _tail.cases_for("quantization")


@pytest.mark.parametrize("name,inputs,kwargs,family", _CASES, ids=_IDS)
def test_op_matches_jax(name, inputs, kwargs, family):
    _tail.run_tail_case(name, inputs, kwargs, family)


def both(name, *args, **kw):
    """The port's op and the JAX op on the same numpy inputs, every
    output bit for bit; the port's outputs as numpy."""
    got = TREG[name].impl(*[torch.from_numpy(np.asarray(a)) for a in args],
                          **kw)
    want = JREG[name].impl(*[jnp.asarray(a) for a in args], **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    outs = []
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
        outs.append(g)
    return outs[0] if len(outs) == 1 else tuple(outs)


# --------------------------------------------- tests/test_quantization.py --
def test_quantize_dequantize_roundtrip_int8():
    x = (np.random.RandomState(0).randn(64) * 3).astype(np.float32)
    q, mn, mx_ = both("_contrib_quantize_v2", x)
    assert q.dtype == np.int8
    back = both("_contrib_dequantize", q, mn, mx_)
    np.testing.assert_allclose(back, x, atol=float(mx_) / 127.0 / 2 + 1e-6)


def test_quantize_uint8_affine():
    x = np.array([0.0, 0.5, 1.0], np.float32)
    q, mn, mx_ = both("_contrib_quantize", x, np.float32(0.0),
                      np.float32(1.0), out_type="uint8")
    np.testing.assert_array_equal(q, [0, 128, 255])
    back = both("_contrib_dequantize", q, mn, mx_)
    np.testing.assert_allclose(back, x, atol=1 / 255)


def test_requantize_int32_to_int8():
    acc = np.array([16129, -8000, 0, 4000], np.int32)
    q, mn, mx_ = both("_contrib_requantize", acc, np.float32(-1.0),
                      np.float32(1.0))
    assert q.dtype == np.int8
    back = both("_contrib_dequantize", q, mn, mx_)
    np.testing.assert_allclose(back, acc / (127.0 * 127.0), atol=1e-2)


def test_quantized_fully_connected_matches_fp32():
    rng = np.random.RandomState(1)
    x = rng.randn(4, 32).astype(np.float32)
    w = rng.randn(8, 32).astype(np.float32)
    qx, _, xmx = both("_contrib_quantize_v2", x)
    qw, _, wmx = both("_contrib_quantize_v2", w)
    out = both("_contrib_quantized_fully_connected", qx, qw,
               x_scale=float(xmx) / 127.0, w_scale=float(wmx) / 127.0)
    np.testing.assert_allclose(out, x @ w.T, rtol=0.1, atol=0.15)


def test_optimal_threshold_rejects_outliers():
    rng = np.random.RandomState(2)
    data = np.concatenate([rng.randn(100000) * 0.5, [50.0]])
    hist, edges = np.histogram(data, bins=4001, range=(-64, 64))
    t = optimal_threshold(hist, edges)
    assert t == jax_thresh(hist, edges)
    assert 0.5 < t < 25.0


# ------------------------------------------------- the int8 x int8 chain --
def test_int32_accumulators_are_exact_at_bert_width():
    """K = 3072 int8 x int8 sums reach ~5e7 > 2^24: f32 would round
    them; the port's f64 product is exact and gives the JAX op's int32
    bits."""
    rng = np.random.RandomState(3)
    qx = np.full((3, 3072), 127, np.int8)
    qx[1:] = rng.randint(-127, 128, (2, 3072))
    qw = np.full((4, 3072), 127, np.int8)
    qw[1:] = rng.randint(-127, 128, (3, 3072))
    acc = TREG["_contrib_quantized_fully_connected"].impl(
        torch.from_numpy(qx), torch.from_numpy(qw))
    want = qx.astype(np.int64) @ qw.astype(np.int64).T
    assert abs(want).max() > 2 ** 24
    np.testing.assert_array_equal(acc.numpy(), want.astype(np.float32))
    from mxnet_tpu_torch.ops.quantization import int8_matmul_i32
    np.testing.assert_array_equal(
        int8_matmul_i32(torch.from_numpy(qx), torch.from_numpy(qw)).numpy(),
        want.astype(np.int32))


def test_int8_chain_bit_for_bit():
    """quantize_v2 -> quantized_fully_connected -> requantize ->
    dequantize, every stage the JAX op's bits."""
    rng = np.random.RandomState(4)
    x = rng.randn(16, 64).astype(np.float32)
    w = (rng.randn(32, 64) * 0.1).astype(np.float32)
    qx, xmn, xmx = both("_contrib_quantize_v2", x)
    qw, wmn, wmx = both("_contrib_quantize_v2", w)
    acc = both("_contrib_quantized_fully_connected", qx, qw)
    acc32 = acc.astype(np.int32)
    t = np.float32(float(xmx) * float(wmx))
    q8, mn, mx_ = both("_contrib_requantize", acc32, -t, t)
    both("_contrib_dequantize", q8, mn, mx_)


def test_quantized_conv_nhwc_bit_for_bit():
    rng = np.random.RandomState(5)
    qx = rng.randint(-127, 128, (2, 9, 9, 8)).astype(np.int8)
    qw = rng.randint(-127, 128, (3, 3, 8, 6)).astype(np.int8)
    both("_contrib_quantized_conv", qx, qw, kernel=(3, 3), stride=(2, 2),
         pad=(1, 1), x_scale=0.01, w_scale=0.02)


# ------------------------------------------- the registered K3 matmul ----
@pytest.mark.parametrize("wdtype", ["int8", "float8_e4m3fn"])
def test_registered_quantized_matmul_matches_the_pallas_kernel(wdtype):
    """``nd.contrib.quantized_matmul`` (the port's registered K3) against
    the JAX package's Pallas kernel in interpret mode, within 1e-5 of the
    output's scale; the TPU tuning keywords are accepted and change
    nothing; ``use_pallas=False`` is the plain version."""
    rng = np.random.RandomState(6)
    w = (rng.randn(64, 48) / 8).astype(np.float32)
    x = rng.randn(24, 64).astype(np.float32)
    jq, js = jax_quantize_leaf(w, wdtype)
    pal = np.asarray(jqz.quantized_matmul(jnp.asarray(x), jq, js,
                                          use_pallas=True, interpret=True,
                                          block_t=8, block_n=16))
    tq = tensor_from_numpy(np.asarray(jq), "cpu")
    ts = torch.from_numpy(np.asarray(js))
    xs = nd.array(x, ctx="cpu")
    got = nd.contrib.quantized_matmul(xs, tq, ts).asnumpy()
    tol = 1e-5 * max(1.0, float(np.abs(pal).max()))
    assert np.abs(got - pal).max() <= tol
    tuned = nd._contrib_quantized_matmul(xs, tq, ts, use_pallas=None,
                                         interpret=True, block_t=128,
                                         block_n=256).asnumpy()
    assert np.array_equal(tuned, got)
    plain = nd.quantized_matmul(xs, tq, ts, use_pallas=False).asnumpy()
    assert np.array_equal(plain, got)


def test_calibrate_entropy_exact():
    rng = np.random.RandomState(7)
    hist, edges = np.histogram(rng.randn(20000) * 0.7, bins=1001,
                               range=(-5.0, 5.0))
    mn, mx_ = both("_contrib_calibrate_entropy", hist.astype(np.float32),
                   edges.astype(np.float32), num_quantized_bins=255)
    assert mn == -mx_ and 0 < mx_ < 5.0


def test_host_ops_are_marked():
    assert TREG["_contrib_calibrate_entropy"].host_op
    assert not TREG["_contrib_quantized_matmul"].host_op

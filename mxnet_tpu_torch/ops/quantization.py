"""Weight-only quantised matmul (the port of the serving matmul in
``mxnet_tpu/ops/quantization.py``).

``out[t, c] = (sum_k x[t, k] * qw[k, c]) * w_scale[c]`` with f32, bf16
or f16 activations (widened to f32, as the TPU kernel widens them), int8
or fp8-e4m3 weights, one f32 scale per output column and an f32
output. :func:`quantized_matmul` takes the plain version for CPU tensors
and launches ``csrc/wq_matmul.cu`` (kernel ``wq_matmul.int8`` /
``wq_matmul.fp8``, the port of ``_wq_matmul_kernel``; each launch counts
under that name in :func:`mxnet_tpu_torch.kernels.launch_counts`) for
CUDA tensors, or raises: the f32 weight matrix is never materialised on
the card.
"""
from __future__ import annotations

import torch

from .. import kernels

__all__ = ["quantized_matmul", "quantized_matmul_reference",
           "kernel_name", "wq_plan"]

# weight dtype -> (C entry point, launch-counter name)
_KERNELS = {torch.int8: ("mxt_wq_matmul_int8", "wq_matmul.int8"),
            torch.float8_e4m3fn: ("mxt_wq_matmul_fp8", "wq_matmul.fp8")}
# x's dtype -> the kernel's x_dtype code
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def kernel_name(weight_dtype):
    """Launch-counter name of the kernel for ``weight_dtype`` weights."""
    return _KERNELS[weight_dtype][1]


# CTAs one launch should put on the card's 132 SMs, the shallowest K
# slice worth its own CTA, the kernel's K step and its largest cluster
# (the portable size)
_TARGET_CTAS = 264
_MIN_K_SLICE = 64
_K_STEP = 32
_MAX_CLUSTER = 8
_SMS = 132


def wq_plan(T, K, N):
    """The kernel's launch plan for a (T, K) x (K, N) product: ``(m_tile,
    n_tile, cluster, k_per_slice)``. The M tile is 16 rows when T <= 16,
    else 64. The N tile is 64 columns, or 256 at T <= 16 when N gives
    every SM a 256-column tile (the LM head): a CTA then reads 256
    contiguous bytes of each weight row. Where the tiles are too few
    for about ``_TARGET_CTAS`` CTAs, the CTAs of one tile split K into
    ``cluster`` slices (a power of two <= 8, one thread-block cluster),
    each a whole number of ``_K_STEP``-deep steps, none shallower than
    ``_MIN_K_SLICE`` unless K is, and none empty."""
    m_tile = 16 if T <= 16 else 64
    n_tile = 256 if m_tile == 16 and N >= 256 * _SMS else 64
    tiles = -(-N // n_tile) * -(-T // m_tile)
    want = max(1, min(_MAX_CLUSTER, K // _MIN_K_SLICE,
                      -(-_TARGET_CTAS // tiles)))
    cluster = 1 << (want.bit_length() - 1)
    while True:
        depth = -(-(-(-K // cluster)) // _K_STEP) * _K_STEP
        if cluster == 1 or (cluster - 1) * depth < K:
            return m_tile, n_tile, cluster, depth
        cluster //= 2


def quantized_matmul_reference(x, qw, w_scale):
    """Plain version: widen x and the weights to f32, one matmul, scale
    each output column after the accumulation; f32 out."""
    return (x.float() @ qw.float()) * w_scale


def _wq_cuda(x, qw, w_scale):
    T, K = x.shape
    N = qw.shape[1]
    dev = x.device
    fn, counter = _KERNELS.get(qw.dtype, (None, None))
    if fn is None:
        raise TypeError(f"quantized_matmul takes int8 or float8_e4m3fn "
                        f"weights, got {qw.dtype}")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"quantized_matmul takes float32, bfloat16 or "
                        f"float16 x, got {x.dtype}")
    kernels.require(x, "x", x.dtype, (T, K), dev)
    kernels.require(qw, "qw", qw.dtype, (K, N), dev)
    kernels.require(w_scale, "w_scale", torch.float32, (N,), dev)
    if qw.data_ptr() % 16:
        raise ValueError("qw must start on a 16-byte boundary")
    out = torch.empty((T, N), dtype=torch.float32, device=dev)
    if T == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    m_tile, n_tile, cluster, depth = wq_plan(T, K, N)
    lib = kernels.library("wq_matmul")
    rc = getattr(lib, fn)(x.data_ptr(), qw.data_ptr(), w_scale.data_ptr(),
                          out.data_ptr(), T, K, N, m_tile, n_tile, cluster,
                          depth, _X_DTYPES[x.dtype],
                          kernels.stream_handle(dev))
    kernels.check(rc, fn)
    kernels.count_launch(counter)
    return out


def quantized_matmul(x, qw, w_scale):
    """Per-output-channel weight-only quantised matmul. x: f32, bf16 or
    f16 ``[T, K]``; qw: int8 or float8_e4m3fn ``[K, N]``; w_scale: f32
    ``[N]``; out f32 ``[T, N]``."""
    if x.device.type == "cpu":
        return quantized_matmul_reference(x, qw, w_scale)
    if x.device.type != "cuda":
        raise ValueError(f"no quantized_matmul kernel for {x.device}")
    return _wq_cuda(x.contiguous(), qw, w_scale)


# ===================================================================
# The registered quantization ops of mxnet_tpu/ops/quantization.py. Each
# returns (out, out_min, out_max), as the reference does, so the range
# bookkeeping composes. int8 is symmetric (scale 127 / max(|min|, |max|),
# codes in [-127, 127]), uint8 affine over [min, max]. The int8 x int8
# products accumulate in int32 bit for bit with the JAX ops: each is a
# float64 product (every int8 x int8 sum is exact in f64 while its
# magnitude stays below 2^53) cast to int32, on the CPU and the card
# alike (PyTorch has no general integer matmul or convolution on CUDA).
# ===================================================================
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from .registry import _REGISTRY, Operator, alias  # noqa: E402


def _reg(name, fn, **kw):
    _REGISTRY[name] = Operator(name, fn, differentiable=False, **kw)


def _f32(v, like):
    return torch.as_tensor(v, dtype=torch.float32,
                           device=like.device).reshape(())


def _thresh(mn, mx):
    return torch.maximum(mn.abs(), mx.abs())


def _div(a, b):
    """``a / b`` as one IEEE division on CPU and card alike, either side a
    tensor or a number (CUDA divides by a Python number through its
    reciprocal, and ``number / tensor`` is ``reciprocal * number`` in
    torch: either can move an int8 code by one)."""
    like = a if isinstance(a, torch.Tensor) else b
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, dtype=torch.float32, device=like.device)
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=torch.float32, device=like.device)
    return torch.div(a, b)


def _int8(x):
    return torch.clamp(torch.round(x), -127, 127).to(torch.int8)


def _quantize(data, min_range, max_range, out_type="int8"):
    mn, mx = _f32(min_range, data), _f32(max_range, data)
    if out_type == "uint8":
        scale = _div(255.0, torch.clamp(mx - mn, min=1e-30))
        q = torch.clamp(torch.round((data - mn) * scale), 0, 255).to(
            torch.uint8)
        return q, mn, mx
    t = _thresh(mn, mx)
    scale = _div(127.0, torch.clamp(t, min=1e-30))
    return _int8(data * scale), -t, t


def _quantize_v2(data, min_calib_range=None, max_calib_range=None,
                 out_type="int8"):
    """The range is the data's where no calibrated range is given."""
    if min_calib_range is None or max_calib_range is None:
        mn, mx = data.min(), data.max()
    else:
        mn, mx = _f32(min_calib_range, data), _f32(max_calib_range, data)
    return _quantize(data, mn, mx, out_type=out_type)


def _dequantize(qdata, min_range, max_range, out_type="float32"):
    mn, mx = _f32(min_range, qdata), _f32(max_range, qdata)
    if qdata.dtype == torch.uint8:
        scale = _div(torch.clamp(mx - mn, min=1e-30), 255.0)
        return qdata.to(torch.float32) * scale + mn
    return qdata.to(torch.float32) * _div(_thresh(mn, mx), 127.0)


def _requantize(qdata, min_range, max_range, min_calib_range=None,
                max_calib_range=None):
    """An int32 accumulator (the product of two int8 ranges: its real
    value is ``q * t / 127^2``) back to int8 at the calibrated range (or
    its own)."""
    mn, mx = _f32(min_range, qdata), _f32(max_range, qdata)
    if qdata.dtype == torch.int32:
        real = qdata.to(torch.float32) * _div(_thresh(mn, mx),
                                                  127.0 * 127.0)
    else:
        real = _dequantize(qdata.to(torch.float32), mn, mx)
    if min_calib_range is None:
        cmn, cmx = real.min(), real.max()
    else:
        cmn, cmx = _f32(min_calib_range, real), _f32(max_calib_range, real)
    return _quantize(real, cmn, cmx)


def _scale_of(x_scale, w_scale, like):
    return torch.as_tensor(x_scale, dtype=torch.float32,
                           device=like.device) * \
        torch.as_tensor(w_scale, dtype=torch.float32, device=like.device)


def int8_matmul_i32(qx, qw):
    """``qx [..., K] @ qw [N, K]^T`` of int8 codes accumulated exactly:
    int32 out."""
    acc = torch.matmul(qx.to(torch.float64), qw.to(torch.float64).t())
    return acc.to(torch.int32)


def int8_conv_nhwc_i32(qx, qw, stride, pad):
    """The int8 NHWC x HWIO convolution accumulated exactly: int32 NHWC
    out."""
    out = F.conv2d(qx.to(torch.float64).permute(0, 3, 1, 2),
                   qw.to(torch.float64).permute(3, 2, 0, 1),
                   stride=tuple(stride), padding=tuple(pad))
    return out.permute(0, 2, 3, 1).to(torch.int32)


def _quantized_fully_connected(qx, qw, x_scale=1.0, w_scale=1.0,
                               num_hidden=0):
    """``(qx @ qw^T)`` accumulated in int32, then scaled back to f32 by
    ``x_scale * w_scale`` (``w_scale`` may be one scale an output
    row)."""
    acc = int8_matmul_i32(qx, qw)
    return acc.to(torch.float32) * _scale_of(x_scale, w_scale, acc)


def _quantized_conv(qx, qw, kernel=None, stride=None, pad=None,
                    num_filter=0, layout="NHWC", x_scale=1.0, w_scale=1.0):
    """int8 convolution accumulated in int32; NHWC data, HWIO weights
    (the JAX op's only layout)."""
    nd_ = qx.ndim - 2
    acc = int8_conv_nhwc_i32(qx, qw, stride or (1,) * nd_,
                             pad or (0,) * nd_)
    return acc.to(torch.float32) * _scale_of(x_scale, w_scale, acc)


def _quantized_act(data, min_data, max_data, act_type="relu"):
    if act_type != "relu":
        raise ValueError("the int8 activation supports relu only")
    mn, mx = _f32(min_data, data), _f32(max_data, data)
    return torch.clamp(data, min=0), torch.clamp(mn, min=0.0), mx


def _quantized_pooling(data, min_data, max_data, kernel=None, stride=None,
                       pad=None, pool_type="max", global_pool=False,
                       layout="NCHW"):
    from .nn import _pooling
    out = _pooling(data.to(torch.float32), kernel=kernel, stride=stride,
                   pad=pad, pool_type=pool_type, global_pool=global_pool,
                   layout=layout)
    out = out.to(data.dtype) if pool_type == "max" else \
        torch.round(out).to(data.dtype)
    return out, _f32(min_data, data), _f32(max_data, data)


def _quantized_flatten(data, min_data, max_data):
    return data.reshape(data.shape[0], -1), _f32(min_data, data), \
        _f32(max_data, data)


def _quantized_concat(arrays, num_args=1, dim=1):
    """Inputs data..., min..., max...: every part requantized to the
    widest range, then concatenated."""
    n = len(arrays) // 3
    datas, mins, maxs = arrays[:n], arrays[n:2 * n], arrays[2 * n:]
    ts = [_thresh(mn.reshape(()), mx.reshape(())) for mn, mx in
          zip(mins, maxs)]
    t_out = ts[0]
    for t in ts[1:]:
        t_out = torch.maximum(t_out, t)
    parts = [_int8(d.to(torch.float32) * _div(t, 127.0) /
                   _div(t_out, 127.0))
             for d, t in zip(datas, ts)]
    return torch.cat(parts, dim=int(dim)), -t_out, t_out


def _quantized_elemwise(op):
    def impl(lhs, rhs, lhs_min, lhs_max, rhs_min, rhs_max):
        tl = _thresh(lhs_min.reshape(()), lhs_max.reshape(()))
        tr = _thresh(rhs_min.reshape(()), rhs_max.reshape(()))
        real = op(lhs.to(torch.float32) * _div(tl, 127.0),
                  rhs.to(torch.float32) * _div(tr, 127.0))
        t = torch.clamp(real.abs().max(), min=1e-30)
        return _int8(real / _div(t, 127.0)), -t, t
    return impl


def _quantized_batch_norm(data, gamma, beta, moving_mean, moving_var,
                          min_data=None, max_data=None, eps=1e-3,
                          min_calib_range=None, max_calib_range=None,
                          **kw):
    t_in = _thresh(min_data.reshape(()), max_data.reshape(()))
    x = data.to(torch.float32) * _div(t_in, 127.0)
    inv = _div(1.0, torch.sqrt(moving_var + eps))
    shape = (1, -1) + (1,) * (data.ndim - 2)
    out = (x - moving_mean.reshape(shape)) * (inv * gamma).reshape(shape) \
        + beta.reshape(shape)
    if min_calib_range is not None:
        t = _f32(max(abs(float(min_calib_range)),
                     abs(float(max_calib_range))), data)
    else:
        t = torch.clamp(out.abs().max(), min=1e-30)
    return _int8(out / _div(t, 127.0)), -t, t


def _quantized_embedding(data, weight, min_weight, max_weight,
                         input_dim=0, output_dim=0, dtype="float32", **kw):
    return weight[data.to(torch.int64)], _f32(min_weight, weight), \
        _f32(max_weight, weight)


def _quantized_matmul_op(x, qw, w_scale, use_pallas=None, interpret=None,
                         block_t=None, block_n=None):
    """The registered form of :func:`quantized_matmul` (the JAX op's
    signature). A CUDA tensor launches ``csrc/wq_matmul.cu``, a CPU
    tensor takes the plain version. ``use_pallas=False`` asks for the
    plain version on either (as the JAX op then runs its oracle): the
    caller's choice, not a fallback. ``interpret``, ``block_t`` and
    ``block_n`` tune the TPU kernel; they are accepted and change
    nothing here, since the CUDA kernel plans its own tiles
    (:func:`wq_plan`)."""
    if use_pallas is False:
        return quantized_matmul_reference(x, qw, w_scale)
    return quantized_matmul(x, qw, w_scale)


def _calibrate_entropy(hist, hist_edges, num_quantized_bins=255):
    """The KL-optimal threshold of a histogram (read on the host):
    (min, max) calibrated range."""
    from ..contrib.quantization import optimal_threshold
    t = optimal_threshold(hist.detach().cpu().numpy(),
                          hist_edges.detach().cpu().numpy(),
                          num_quantized_bins=int(num_quantized_bins))
    t = np.float32(t)
    return _f32(-t, hist), _f32(t, hist)


_reg("_contrib_quantized_matmul", _quantized_matmul_op)
alias("quantized_matmul", "_contrib_quantized_matmul")
_reg("_contrib_quantize", _quantize, nout=3)
_reg("_contrib_quantize_v2", _quantize_v2, nout=3)
_reg("_contrib_dequantize", _dequantize)
_reg("_contrib_requantize", _requantize, nout=3)
_reg("_contrib_quantized_fully_connected", _quantized_fully_connected)
_reg("_contrib_quantized_conv", _quantized_conv)
_reg("_contrib_quantized_act", _quantized_act, nout=3)
_reg("_contrib_quantized_pooling", _quantized_pooling, nout=3)
_reg("_contrib_quantized_flatten", _quantized_flatten, nout=3)
_reg("_contrib_quantized_concat", _quantized_concat, nout=3, variadic=True)
_reg("_contrib_quantized_elemwise_add",
     _quantized_elemwise(lambda a, b: a + b), nout=3)
_reg("_contrib_quantized_elemwise_mul",
     _quantized_elemwise(lambda a, b: a * b), nout=3)
_reg("_contrib_quantized_batch_norm", _quantized_batch_norm, nout=3)
_reg("_contrib_quantized_embedding", _quantized_embedding, nout=3)
_reg("_contrib_calibrate_entropy", _calibrate_entropy, nout=2,
     host_op=True)

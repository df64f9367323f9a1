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

"""Weight-only quantised matmul (the port of the serving matmul in
``mxnet_tpu/ops/quantization.py``).

``out[t, c] = (sum_k x[t, k] * qw[k, c]) * w_scale[c]`` with f32
activations, int8 or fp8-e4m3 weights and one f32 scale per output
column. :func:`quantized_matmul` takes the plain version for CPU tensors
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
           "kernel_name", "k_splits"]

# weight dtype -> (C entry point, launch-counter name)
_KERNELS = {torch.int8: ("mxt_wq_matmul_int8", "wq_matmul.int8"),
            torch.float8_e4m3fn: ("mxt_wq_matmul_fp8", "wq_matmul.fp8")}


def kernel_name(weight_dtype):
    """Launch-counter name of the kernel for ``weight_dtype`` weights."""
    return _KERNELS[weight_dtype][1]


# CTAs one launch should put on the card's 132 SMs, and the shallowest K
# slice worth its own CTA
_TARGET_CTAS = 264
_MIN_K_SLICE = 128


def k_splits(T, K, N):
    """How many K slices the kernel splits a (T, K) x (K, N) product
    into: enough that the launch has about ``_TARGET_CTAS`` CTAs (64
    columns by 16 rows per tile when T <= 16, else 64 rows), no slice
    shallower than ``_MIN_K_SLICE``, and no slice empty."""
    tiles = -(-N // 64) * -(-T // (16 if T <= 16 else 64))
    want = max(1, min(K // _MIN_K_SLICE, -(-_TARGET_CTAS // tiles)))
    depth = -(-(-(-K // want)) // 16) * 16     # whole 16-deep steps
    return -(-K // depth)


def quantized_matmul_reference(x, qw, w_scale):
    """Plain version: widen the weights, one matmul, scale each output
    column after the accumulation."""
    return (x @ qw.float()) * w_scale


def _wq_cuda(x, qw, w_scale):
    T, K = x.shape
    N = qw.shape[1]
    dev = x.device
    fn, counter = _KERNELS.get(qw.dtype, (None, None))
    if fn is None:
        raise TypeError(f"quantized_matmul takes int8 or float8_e4m3fn "
                        f"weights, got {qw.dtype}")
    kernels.require(x, "x", torch.float32, (T, K), dev)
    kernels.require(qw, "qw", qw.dtype, (K, N), dev)
    kernels.require(w_scale, "w_scale", torch.float32, (N,), dev)
    out = torch.empty((T, N), dtype=torch.float32, device=dev)
    if T == 0 or N == 0:
        return out
    splits = k_splits(T, K, N)
    scratch = (torch.empty((splits, T, N), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    lib = kernels.library("wq_matmul")
    rc = getattr(lib, fn)(x.data_ptr(), qw.data_ptr(), w_scale.data_ptr(),
                          out.data_ptr(),
                          None if scratch is None else scratch.data_ptr(),
                          T, K, N, splits, kernels.stream_handle(dev))
    kernels.check(rc, fn)
    kernels.count_launch(counter)
    return out


def quantized_matmul(x, qw, w_scale):
    """Per-output-channel weight-only quantised matmul. x: f32 ``[T,
    K]``; qw: int8 or float8_e4m3fn ``[K, N]``; w_scale: f32 ``[N]``."""
    if x.device.type == "cpu":
        return quantized_matmul_reference(x, qw, w_scale)
    if x.device.type != "cuda":
        raise ValueError(f"no quantized_matmul kernel for {x.device}")
    return _wq_cuda(x.contiguous(), qw, w_scale)

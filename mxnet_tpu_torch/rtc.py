"""``rtc``: a user's CUDA kernel as a framework op (the port of
``mxnet_tpu/rtc.py``, whose ``register_pallas_op`` registers a Pallas
body; the reference MXNet's ``CudaModule`` compiled CUDA C at run time).

:func:`register_cuda_op` compiles a CUDA source string with ``nvcc`` at
the op's first call on the card (:func:`mxnet_tpu_torch.kernels
.rtc_library`; cached in ``_build/`` by a hash of the source) and
registers the kernel as an op, available at once as ``nd.<name>``::

    from mxnet_tpu_torch import nd, rtc

    SRC = '''
    extern "C" __global__ void scale_add(const float* x, const float* y,
                                         float* out, long long nx,
                                         long long ny, long long n) {
      long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
      if (i < n) out[i] = 2.f * x[i] + y[i];
    }'''
    rtc.register_cuda_op("my_scale_add", SRC, "scale_add")
    out = nd.my_scale_add(a, b)          # a, b: CUDA tensors

The calling convention is fixed: the kernel takes each input's pointer
in order, then the output's pointer, then each input's ``numel`` and the
output's ``numel`` as ``long long``. The wrapper allocates the output
(shape and dtype from ``out_shape(shapes, dtypes)``, default input 0's)
and launches ``grid`` blocks of ``block`` threads on PyTorch's current
stream; each is a tuple of up to three ints or a callable of the input
shapes returning one (default ``ceil(numel_out / 256)`` blocks of 256).
Inputs must be contiguous tensors on one card. ``kernel_name`` names one
non-template ``__global__`` function of the source.

With ``reference_fn`` (a plain PyTorch function of the same math) the op
is differentiable: the kernel runs the forward and the backward is the
vjp of ``reference_fn`` (``torch.func.vjp``), as the JAX package's
``custom_vjp``. On CPU tensors the op runs ``reference_fn``; without one
a CPU call raises. Each launch counts as ``rtc.<name>`` in
:func:`mxnet_tpu_torch.kernels.launch_counts`.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels

__all__ = ["register_cuda_op", "register_pallas_op", "CudaModule"]

_BLOCK = 256


def _default_out(shapes, dtypes):
    return shapes[0], dtypes[0]


def _dims(spec, shapes, default):
    """``spec`` (a tuple, an int or a callable of the input shapes) as
    three launch dimensions."""
    d = default if spec is None else (spec(shapes) if callable(spec)
                                      else spec)
    d = (d,) if isinstance(d, int) else tuple(int(x) for x in d)
    if not 1 <= len(d) <= 3 or min(d) < 1:
        raise ValueError(f"launch dimensions must be 1 to 3 positive ints, "
                         f"got {d}")
    return d + (1,) * (3 - len(d))


def _with_vjp(forward, reference_fn):
    """``forward`` as an autograd Function whose backward is the vjp of
    ``reference_fn``."""

    class _Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *xs):
            ctx.save_for_backward(*xs)
            return forward(*xs)

        @staticmethod
        def backward(ctx, g):
            _, vjp = torch.func.vjp(reference_fn, *ctx.saved_tensors)
            return vjp(g)

    return _Op.apply


def register_cuda_op(name, source, kernel_name, out_shape=None, grid=None,
                     block=None, reference_fn=None):
    """Register ``source``'s ``__global__`` function ``kernel_name`` as
    the op ``name`` (see the module docstring for the calling convention
    and the arguments). Returns ``name``; the op is at once available as
    ``nd.<name>``."""
    shape_fn = out_shape or _default_out
    counter = f"rtc.{name}"

    def run_kernel(*xs):
        dev = xs[0].device
        for i, x in enumerate(xs):
            if x.device != dev:
                raise ValueError(f"{name}: input {i} is on {x.device}, "
                                 f"input 0 on {dev}")
            if not x.is_contiguous():
                raise ValueError(f"{name}: input {i} must be contiguous")
        shapes = [tuple(x.shape) for x in xs]
        oshape, odtype = shape_fn(shapes, [x.dtype for x in xs])
        out = torch.empty(oshape, dtype=odtype, device=dev)
        if out.numel() == 0:
            return out
        lib = kernels.rtc_library(source, kernel_name)
        g = _dims(grid, shapes, -(-out.numel() // _BLOCK))
        b = _dims(block, shapes, _BLOCK)
        vals = ([ctypes.c_void_p(x.data_ptr()) for x in xs]
                + [ctypes.c_void_p(out.data_ptr())]
                + [ctypes.c_longlong(x.numel()) for x in xs + (out,)])
        argv = (ctypes.c_void_p * len(vals))(
            *[ctypes.addressof(v) for v in vals])
        rc = lib.mxt_rtc_launch(argv, *g, *b, kernels.stream_handle(dev))
        kernels.check(rc, f"rtc kernel {kernel_name}")
        kernels.count_launch(counter)
        return out

    core = run_kernel if reference_fn is None else _with_vjp(run_kernel,
                                                             reference_fn)

    def impl(*xs, **kw):
        if not xs:
            raise ValueError(f"{name} takes at least one input tensor")
        if xs[0].device.type == "cpu":
            if reference_fn is None:
                raise RuntimeError(
                    f"{name}: a CUDA kernel has no CPU mode; register it "
                    f"with reference_fn= to run it on CPU tensors")
            return reference_fn(*xs)
        if xs[0].device.type != "cuda":
            raise ValueError(f"{name}: no kernel for {xs[0].device}")
        return core(*xs)

    impl.__doc__ = f"User CUDA kernel {kernel_name!r} registered by rtc."
    from .ops.registry import _REGISTRY, Operator
    _REGISTRY[name] = Operator(name, impl,
                               differentiable=reference_fn is not None)
    from . import ndarray as _nd
    from .ndarray.register import make_op_func
    setattr(_nd, name, make_op_func(_REGISTRY[name]))
    return name


def register_pallas_op(*args, **kwargs):
    """The JAX package's Pallas registration; a Pallas body does not run
    on the card. Write the kernel in CUDA C and use
    :func:`register_cuda_op`."""
    raise NotImplementedError(
        "Pallas kernel bodies do not run on the card; write the kernel in "
        "CUDA C and register it with mxnet_tpu_torch.rtc.register_cuda_op "
        "(module docstring has a template)")


class CudaModule:
    """The reference MXNet's run-time CUDA module; the port registers a
    CUDA source as an op instead: :func:`register_cuda_op`."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "CudaModule is not ported; compile and register a CUDA kernel "
            "as an op with mxnet_tpu_torch.rtc.register_cuda_op (module "
            "docstring has a template)")

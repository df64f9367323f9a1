"""Neural-network operators (the port of ``mxnet_tpu/ops/nn.py``).

The functions gluon calls (``FullyConnected``, ``LayerNorm``,
``Activation``, ``Embedding``, ``Dropout``, ``log_softmax``, ``pick``,
``dot``) are plain functions on tensors with gluon's signatures; the
registry (the second half of this module) holds every op of the JAX
module under its name and signature, calling them where they exist.
Convolutions, pooling and resizing are ``torch.nn.functional``'s, as the
JAX package leaves them to XLA's ``lax.conv`` and ``reduce_window``
outside any Pallas kernel; pooling pads explicitly and reduces over
unfolded windows, so the reference's ``full`` convention and
``count_include_pad`` hold. ``BatchNorm``'s running statistics stay the
caller's, as in the reference.

``FullyConnected`` keeps MXNet's weight layout ``(units, in_units)``;
its product, and ``dot``'s, is ``torch.matmul``, as the JAX package
leaves it to XLA. Gluon layers call these through ``F`` in
``hybrid_forward``, not through the op chokepoint, so each function
applies the chokepoint's AMP cast under its registered name itself
(:func:`~.invoke.amp_cast`): under ``amp.init()`` ``FullyConnected``,
``Embedding`` and ``dot`` run in the target dtype, ``LayerNorm`` and
``log_softmax`` in f32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import autograd
from ..base import torch_dtype
from .elemwise import relu
from .invoke import amp_cast
from .registry import _REGISTRY, Operator, alias

__all__ = ["FullyConnected", "LayerNorm", "Activation", "Embedding",
           "Dropout", "log_softmax", "pick", "dot"]


@amp_cast("FullyConnected")
def FullyConnected(x, weight, bias=None, flatten=True):
    """``dot(x, weight^T) + bias``; ``flatten=True`` first folds every
    axis after the first into one, ``flatten=False`` applies to the last
    axis."""
    if flatten and x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    out = torch.matmul(x, weight.t())
    return out if bias is None else out + bias


@amp_cast("LayerNorm")
def LayerNorm(x, gamma, beta, axis=-1, eps=1e-5):
    """Normalise over ``axis`` (biased variance), then scale and shift."""
    mean = x.mean(dim=axis, keepdim=True)
    var = (x - mean).square().mean(dim=axis, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    return out * gamma.reshape(shape) + beta.reshape(shape)


_ACTIVATIONS = {
    "relu": relu,              # jnp.maximum(x, 0)'s bits
    "tanh": torch.tanh,
    # exact erf form, as jax.nn.gelu(approximate=False)
    "gelu": torch.nn.functional.gelu,
    "sigmoid": torch.sigmoid,
    "softrelu": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "softsign": lambda x: x / (1 + x.abs()),
    "log_sigmoid": torch.nn.functional.logsigmoid,
    "silu": torch.nn.functional.silu,
    "mish": lambda x: x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x))),
}


@amp_cast("Activation")
def Activation(x, act_type="relu"):
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise ValueError(f"unknown act_type {act_type}")
    return fn(x)


@amp_cast("Embedding")
def Embedding(data, weight):
    """Rows of ``weight`` at ``data``; indices may arrive as floats and
    are truncated to integers, as ``astype(int32)`` does. Under AMP float
    indices are cast to the target dtype first, as in the reference
    (ids above 256 then round in bf16): pass integer ids."""
    return torch.nn.functional.embedding(data.long(), weight)


@amp_cast("Dropout")
def Dropout(x, p=0.5, generator=None, axes=()):
    """Inverted dropout, active only in training mode
    (``autograd.is_training()``), one mask entry shared along ``axes``.
    Draws from ``generator`` (default: torch's generator of ``x``'s
    device)."""
    if p == 0 or not autograd.is_training():
        return x
    shape = list(x.shape)
    for a in axes or ():
        shape[a] = 1
    keep = torch.rand(shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


@amp_cast("log_softmax")
def log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


@amp_cast("pick")
def pick(x, index, axis=-1, keepdims=False):
    """``x`` at ``index`` along ``axis`` (indices clipped into range)."""
    ax = axis % x.ndim
    idx = index.long().clamp(0, x.shape[ax] - 1).unsqueeze(ax)
    out = torch.gather(x, ax, idx)
    return out if keepdims else out.squeeze(ax)


@amp_cast("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """The reference's ``dot``: the last axis of ``lhs`` contracted with
    the first of ``rhs``, each reversed first where its ``transpose_*``
    is set."""
    if transpose_a:
        lhs = lhs.permute(*reversed(range(lhs.ndim)))
    if transpose_b:
        rhs = rhs.permute(*reversed(range(rhs.ndim)))
    if lhs.ndim == 2 and rhs.ndim == 2:
        return torch.matmul(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=1)


# ---------------------------------------------------------------------------
# The registered nn ops (``mxnet_tpu/ops/nn.py``'s names and signatures).
# The functions above keep the signatures gluon calls them with; the
# registry takes the reference's (``*args`` inputs, ``num_hidden=``,
# ``no_bias=`` ...) and calls them.
# ---------------------------------------------------------------------------
def _tup(v, n):
    if v is None:
        return (1,) * n if n else ()
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


_DEFAULT_LAYOUT = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _layout(layout, nd):
    return layout or _DEFAULT_LAYOUT[nd]


def _to_channels_first(x, lay):
    """``x`` in layout ``lay`` permuted to N, C, spatial... (and the
    permutation back)."""
    order = [lay.index("N"), lay.index("C")] + [
        i for i, c in enumerate(lay) if c not in "NC"]
    back = [order.index(i) for i in range(len(order))]
    return x.permute(*order), back


def _fully_connected_op(*args, num_hidden=0, no_bias=False, flatten=True):
    bias = args[2] if not no_bias and len(args) > 2 else None
    if not flatten and args[0].ndim > 2:
        out = torch.matmul(args[0], args[1].t())
        return out if bias is None else out + bias
    return FullyConnected(args[0], args[1], bias, flatten)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _convolution(*args, kernel=None, stride=None, dilate=None, pad=None,
                 num_filter=0, num_group=1, no_bias=False, layout=None,
                 workspace=None, cudnn_tune=None, cudnn_off=None):
    x, w = args[0], args[1]
    nd = len(kernel) if kernel else x.ndim - 2
    lay = _layout(layout, nd)
    xc, back = _to_channels_first(x, lay)
    # weights: the data layout with N->O, C->I
    wc, _ = _to_channels_first(w, lay)
    bias = args[2] if not no_bias and len(args) > 2 else None
    out = _CONV[nd](xc, wc, bias, stride=_tup(stride, nd),
                    padding=_tup(pad, nd) if pad is not None else 0,
                    dilation=_tup(dilate, nd), groups=num_group)
    return out.permute(*back)


def _deconvolution(*args, kernel=None, stride=None, dilate=None, pad=None,
                   adj=None, target_shape=None, num_filter=0, num_group=1,
                   no_bias=True, layout=None, workspace=None,
                   cudnn_tune=None, cudnn_off=None):
    x, w = args[0], args[1]
    nd = len(kernel) if kernel else x.ndim - 2
    lay = _layout(layout, nd)
    xc, back = _to_channels_first(x, lay)
    # weights: the data layout with N->I, C->O, as torch's (in, out/g, ...)
    wc, _ = _to_channels_first(w, lay)
    bias = args[2] if not no_bias and len(args) > 2 else None
    out = _DECONV[nd](xc, wc, bias, stride=_tup(stride, nd),
                      padding=_tup(pad, nd) if pad is not None else 0,
                      output_padding=_tup(adj, nd) if adj is not None else 0,
                      groups=num_group, dilation=_tup(dilate, nd))
    return out.permute(*back)


def _s2d_stem_conv(x, w, num_filter=0, no_bias=True, layout="NHWC"):
    """The 7x7, stride-2, pad-3 stem convolution (NHWC data, OHWI
    weights). The JAX package computes it as a 4x4 stride-1 convolution
    over a 2x2 space-to-depth input (a TPU layout device, numerically the
    same convolution); here it is the convolution itself."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), stride=2,
                   padding=3)
    return out.permute(0, 2, 3, 1)


def _pool_pads(shape, kernel, stride, pad, convention, sp_axes):
    pads = []
    for i, ax in enumerate(sp_axes):
        if convention == "full":
            # the reference's 'full' convention: ceil instead of floor
            in_sz = shape[ax] + 2 * pad[i]
            out_sz = -(-(in_sz - kernel[i]) // stride[i]) + 1
            need = (out_sz - 1) * stride[i] + kernel[i] - shape[ax]
            pads.append((pad[i], max(need - pad[i], pad[i])))
        else:
            pads.append((pad[i], pad[i]))
    return pads


def _windows(x, sp_axes, kernel, stride, pads, value):
    """``x`` padded with ``value`` and unfolded: one trailing axis per
    spatial axis holding its window (a view)."""
    flat = [0] * (2 * x.ndim)
    for ax, (lo, hi) in zip(sp_axes, pads):
        j = 2 * (x.ndim - 1 - ax)
        flat[j], flat[j + 1] = lo, hi
    if any(flat):
        x = F.pad(x, flat, value=value)
    for ax, k, s in zip(sp_axes, kernel, stride):
        x = x.unfold(ax, k, s)
    return x


def _pooling(x, kernel=None, pool_type="max", global_pool=False, stride=None,
             pad=None, pooling_convention="valid", count_include_pad=True,
             layout=None, cudnn_off=None, p_value=None):
    nd = x.ndim - 2
    lay = _layout(layout, nd)
    sp_axes = [i for i, c in enumerate(lay) if c not in "NC"]
    if global_pool:
        kernel = tuple(x.shape[a] for a in sp_axes)
        stride = (1,) * nd
        pad = (0,) * nd
    kernel = _tup(kernel, nd)
    stride = _tup(stride, nd)
    pad = _tup(pad, nd) if pad is not None else (0,) * nd
    pads = _pool_pads(x.shape, kernel, stride, pad, pooling_convention,
                      sp_axes)
    red = tuple(range(x.ndim, x.ndim + nd))
    if pool_type == "max":
        low = float("-inf") if x.is_floating_point() else \
            torch.iinfo(x.dtype).min
        return torch.amax(_windows(x, sp_axes, kernel, stride, pads, low),
                          dim=red)
    if pool_type in ("avg", "sum"):
        s = torch.sum(_windows(x, sp_axes, kernel, stride, pads, 0), dim=red)
        if pool_type == "sum":
            return s
        if count_include_pad:
            # a 0-d tensor (divided exactly, unlike a Python scalar on
            # the card), filled on the device: a CUDA graph can carry it
            return s / torch.full((), math.prod(kernel), dtype=x.dtype,
                                  device=x.device)
        cnt = torch.sum(_windows(torch.ones_like(x), sp_axes, kernel,
                                 stride, pads, 0), dim=red)
        return s / cnt
    if pool_type == "lp":
        p = p_value or 2
        s = torch.sum(_windows(x.abs() ** p, sp_axes, kernel, stride, pads,
                               0), dim=red)
        return s ** (1.0 / p)
    raise ValueError(f"unknown pool_type {pool_type}")


def _resize_linear(x, size):
    """``jax.image.resize(method="linear")`` of an NCHW batch: half-pixel
    centres, a triangle filter widened when downsampling (antialias)."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=True)


def _adaptive_avg_pool2d(x, output_size=1):
    oh, ow = _tup(output_size, 2)
    b, c, h, w = x.shape
    if h % oh == 0 and w % ow == 0:
        return x.reshape(b, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    return _resize_linear(x, (oh, ow))


def _upsampling(*args, scale=1, sample_type="nearest", num_filter=0,
                multi_input_mode="concat", num_args=1, workspace=None):
    x = args[0]
    if sample_type == "nearest":
        return x.repeat_interleave(scale, dim=2).repeat_interleave(scale,
                                                                   dim=3)
    return _resize_linear(x, (x.shape[2] * scale, x.shape[3] * scale))


def _bilinear_resize2d(x, height=None, width=None, scale_height=None,
                       scale_width=None, mode=None, align_corners=True):
    # the JAX op resizes with half-pixel centres whatever align_corners
    oh = height or int(x.shape[2] * scale_height)
    ow = width or int(x.shape[3] * scale_width)
    return _resize_linear(x, (oh, ow))


# ------------------------------------------------------- normalization -----
def _bn_apply(x, gamma, beta, mean32, var32, eps, axis):
    """``x * scale + shift`` with f32 per-channel scale and shift cast to
    ``x``'s dtype (one elementwise pass, as the reference folds it)."""
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    scale = torch.rsqrt(var32 + eps) * gamma.to(torch.float32)
    shift = beta.to(torch.float32) - mean32 * scale
    return x * scale.to(x.dtype).reshape(shape) \
        + shift.to(x.dtype).reshape(shape)


def _batch_norm(*args, eps=1e-3, momentum=0.9, fix_gamma=True,
                use_global_stats=False, output_mean_var=False, axis=1,
                cudnn_off=None, _training=False):
    """Returns out, or (out, batch_mean, batch_var) with
    ``output_mean_var``. The running statistics stay the caller's
    (gluon's BatchNorm updates them), as in the reference."""
    x, gamma, beta, mmean, mvar = args[:5]
    axis = axis % x.ndim
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    if _training and not use_global_stats:
        # E[x] and E[x^2] - E[x]^2 in f32 over one read of x
        red = tuple(i for i in range(x.ndim) if i != axis)
        xf = x.to(torch.float32)
        mean32 = xf.mean(dim=red)
        var32 = torch.clamp((xf * xf).mean(dim=red) - mean32 * mean32,
                            min=0.0)
        mean, var = mean32.to(x.dtype), var32.to(x.dtype)
    else:
        mean, var = mmean, mvar
        mean32, var32 = mean.to(torch.float32), var.to(torch.float32)
    out = _bn_apply(x, gamma, beta, mean32, var32, eps, axis)
    if output_mean_var:
        return out, mean, var
    return out


def _batch_norm_with_relu(*args, **kw):
    out = _batch_norm(*args, **kw)
    if isinstance(out, tuple):
        return (relu(out[0]),) + out[1:]
    return relu(out)


def _sync_batch_norm(*args, eps=1e-3, momentum=0.9, fix_gamma=True,
                     use_global_stats=False, output_mean_var=False, ndev=1,
                     key=None, axis=1, axis_name=None, _training=False,
                     **kw):
    """SyncBatchNorm on one device: BatchNorm (the JAX op averages the
    moments over ``axis_name`` inside a mapped program; one device has
    nothing to average)."""
    return _batch_norm(*args[:5], eps=eps, momentum=momentum,
                       fix_gamma=fix_gamma,
                       use_global_stats=use_global_stats,
                       output_mean_var=output_mean_var, axis=axis,
                       _training=_training)


def _group_norm(x, gamma, beta, num_groups=1, eps=1e-5,
                output_mean_var=False):
    b, c = x.shape[:2]
    xg = x.reshape((b, num_groups, c // num_groups) + x.shape[2:])
    red = tuple(range(2, xg.ndim))
    mean = xg.mean(dim=red, keepdim=True)
    var = (xg - mean).square().mean(dim=red, keepdim=True)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = [1, c] + [1] * (x.ndim - 2)
    return out * gamma.reshape(shape) + beta.reshape(shape)


def _instance_norm(x, gamma, beta, eps=1e-3):
    red = tuple(range(2, x.ndim))
    mean = x.mean(dim=red, keepdim=True)
    var = (x - mean).square().mean(dim=red, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    shape = [1, x.shape[1]] + [1] * (x.ndim - 2)
    return out * gamma.reshape(shape) + beta.reshape(shape)


def _l2_normalization(x, eps=1e-10, mode="instance"):
    if mode == "instance":
        red = tuple(range(1, x.ndim))
    elif mode == "channel":
        red = (1,)
    else:
        red = tuple(range(2, x.ndim))
    return x / torch.sqrt(x.square().sum(dim=red, keepdim=True) + eps)


def _lrn(x, nsize=5, alpha=1e-4, beta=0.75, knorm=2.0):
    half = nsize // 2
    sq = F.pad(x.square(), (0, 0, 0, 0, half, half))
    s = sq.unfold(1, nsize, 1).sum(dim=-1)
    return x / torch.pow(knorm + alpha * s / nsize, beta)


# ------------------------------------------------------------ softmax ------
def _softmax(x, axis=-1, temperature=None, length=None, use_length=False,
             dtype=None):
    if temperature:
        x = x / temperature
    if use_length and length is not None:
        steps = torch.arange(x.shape[axis], device=x.device)
        mask = steps[None, :] < length[:, None]
        if x.ndim > 2:
            mask = mask.reshape(mask.shape + (1,) * (x.ndim - 2))
        x = torch.where(mask, x, torch.full((), float("-inf"),
                                            dtype=x.dtype, device=x.device))
    out = torch.softmax(x, dim=axis)
    return out.to(torch_dtype(dtype)) if dtype else out


def _log_softmax_op(x, axis=-1, temperature=None, dtype=None):
    if temperature:
        x = x / temperature
    out = log_softmax(x, axis)
    return out.to(torch_dtype(dtype)) if dtype else out


def _one_hot(label, depth, dtype):
    """One-hot rows of ``label`` (a row of zeros where it is out of
    range, as ``jax.nn.one_hot``)."""
    return (label.long()[..., None] == torch.arange(
        depth, device=label.device)).to(dtype)


def _softmax_cross_entropy(data, label):
    logp = torch.log_softmax(data, dim=-1)
    onehot = _one_hot(label, data.shape[-1], data.dtype)
    return torch.sum(-torch.sum(onehot * logp, dim=-1))


class _SoftmaxOutputFn(torch.autograd.Function):
    """Softmax forward; the backward ignores the head gradient and gives
    ``(p - onehot(label)) * grad_scale`` (masked at ``ignore_label``),
    the reference's output-layer contract."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore):
        out = torch.softmax(data, dim=-1)
        ctx.save_for_backward(out, label)
        ctx.cfg = (grad_scale, ignore_label, use_ignore)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore = ctx.cfg
        onehot = _one_hot(label, out.shape[-1], out.dtype)
        grad = (out - onehot) * grad_scale
        if use_ignore:
            grad = grad * (label != ignore_label).to(out.dtype)[..., None]
        return grad, None, None, None, None


def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    use_ignore=False, multi_output=False, preserve_shape=False,
                    normalization="null", out_grad=False, smooth_alpha=0.0):
    flat = data.reshape(-1, data.shape[-1]) if data.ndim > 2 else data
    lab = label.reshape(-1) if label.ndim > 1 else label
    scale = grad_scale / flat.shape[0] if normalization == "batch" \
        else grad_scale
    return _SoftmaxOutputFn.apply(flat, lab, scale, ignore_label,
                                  use_ignore).reshape(data.shape)


# --------------------------------------------------------- activation ------
def _leaky_relu(*args, act_type="leaky", slope=0.25, lower_bound=0.125,
                upper_bound=0.334, rng=None, _training=False):
    x = args[0]
    if act_type == "leaky":
        return torch.where(x > 0, x, slope * x)
    if act_type == "prelu":
        gamma = args[1]
        g = gamma.reshape((1, -1) + (1,) * (x.ndim - 2)) if x.ndim > 1 \
            else gamma
        return torch.where(x > 0, x, g * x)
    if act_type == "elu":
        return torch.where(x > 0, x, slope * torch.expm1(x))
    if act_type == "selu":
        a, s = 1.6732632423543772, 1.0507009873554805
        return s * torch.where(x > 0, x, a * torch.expm1(x))
    if act_type == "gelu":
        return F.gelu(x)
    if act_type == "rrelu":
        if _training and rng is not None:
            u = lower_bound + (upper_bound - lower_bound) * torch.rand(
                x.shape, generator=rng, device=rng.device, dtype=x.dtype)
        else:
            u = (lower_bound + upper_bound) / 2
        return torch.where(x > 0, x, u * x)
    raise ValueError(f"unknown act_type {act_type}")


def _dropout_op(x, rng=None, p=0.5, mode="training", axes=(), cudnn_off=None,
                _training=False):
    if p == 0 or (not _training and mode != "always"):
        return x
    shape = list(x.shape)
    for a in (axes or ()):
        shape[a] = 1
    keep = torch.rand(shape, generator=rng, device=rng.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _embedding_op(data, weight, input_dim=0, output_dim=0, dtype="float32",
                  sparse_grad=False):
    return Embedding(data, weight)


# ---------------------------------------------------------------- ctc ------
def _ctc_loss(data, label, data_lengths=None, label_lengths=None,
              use_data_lengths=False, use_label_lengths=False,
              blank_label="first"):
    """CTC loss of (T, B, A) activations against (B, L) labels on the
    reference's conventions: ``blank_label="first"``: blank 0, labels
    1..A-1 padded with -1 (or 0); ``"last"``: blank A-1, labels 0..A-2
    padded with -1 (or A-1). ``F.ctc_loss`` computes it (sum over the
    sequence, no reduction), in f32."""
    T, B, A = data.shape
    logp = torch.log_softmax(data.to(torch.float32), dim=-1)
    blank = 0 if blank_label == "first" else A - 1
    lab = label.long()
    pad_val = -1 if blank_label == "first" else blank
    if data_lengths is not None and not isinstance(data_lengths,
                                                   torch.Tensor):
        data_lengths = torch.as_tensor(np.asarray(data_lengths))
    if label_lengths is not None and not isinstance(label_lengths,
                                                    torch.Tensor):
        label_lengths = torch.as_tensor(np.asarray(label_lengths))
    if label_lengths is not None and use_label_lengths:
        lab_len = label_lengths.long().to(data.device)
    else:
        lab_len = ((lab != pad_val) & (lab != -1)).sum(dim=1)
    if data_lengths is not None and use_data_lengths:
        dat_len = data_lengths.long().to(data.device)
    else:
        dat_len = torch.full((B,), T, dtype=torch.long, device=data.device)
    targets = torch.where(lab < 0, torch.zeros_like(lab), lab)
    loss = F.ctc_loss(logp, targets, dat_len, lab_len, blank=blank,
                      reduction="none", zero_infinity=False)
    return loss.to(data.dtype)


def _correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                 stride2=1, pad_size=0, is_multiply=True):
    """The FlowNet correlation layer (NCHW): output channel d indexes the
    displacement grid, each value the mean over channels (and the kernel
    window) of the product of data1 at (i, j) and data2 at (i+di, j+dj)."""
    n, c, h, w = data1.shape
    d = int(max_displacement)
    disps = list(range(-d, d + 1, int(stride2)))
    p = pad_size
    x1 = F.pad(data1, (p, p, p, p))
    x2 = F.pad(data2, (p + d, p + d, p + d, p + d))
    hh, ww = x1.shape[2], x1.shape[3]
    outs = []
    for di in disps:
        for dj in disps:
            shifted = x2[:, :, d + di:d + di + hh, d + dj:d + dj + ww]
            prod = x1 * shifted if is_multiply else -(x1 - shifted).abs()
            corr = prod.mean(dim=1)
            if kernel_size > 1:
                k = int(kernel_size)
                corr = F.pad(corr, (k // 2, k // 2, k // 2, k // 2))
                corr = corr.unfold(1, k, 1).unfold(2, k, 1).sum(
                    dim=(-1, -2)) / (k * k)
            outs.append(corr)
    out = torch.stack(outs, dim=1)
    if stride1 > 1:
        out = out[:, :, ::int(stride1), ::int(stride1)]
    return out


def _batch_dot(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = torch.swapaxes(a, -1, -2)
    if transpose_b:
        b = torch.swapaxes(b, -1, -2)
    return torch.matmul(a, b)


def _layer_norm_op(x, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    return LayerNorm(x, gamma, beta, axis, eps)


def _pick_op(x, index, axis=-1, keepdims=False, mode="clip"):
    return pick(x, index, axis, keepdims)


def _activation_op(x, act_type="relu"):
    return Activation(x, act_type)


def _reg(name, fn, aliases=(), **kw):
    _REGISTRY[name] = Operator(name, fn, **kw)
    for a in aliases:
        alias(a, name)


_reg("FullyConnected", _fully_connected_op, ("fully_connected",))
_reg("dot", dot)
_reg("batch_dot", _batch_dot)
_reg("Convolution", _convolution, ("convolution",))
_reg("Deconvolution", _deconvolution)
_reg("_s2d_stem_conv", _s2d_stem_conv)
_reg("Pooling", _pooling, ("pooling",))
_reg("_contrib_AdaptiveAvgPooling2D", _adaptive_avg_pool2d)
_reg("UpSampling", _upsampling)
_reg("_contrib_BilinearResize2D", _bilinear_resize2d)
_reg("BatchNorm", _batch_norm, ("batch_norm",), needs_train=True)
_reg("LayerNorm", _layer_norm_op, ("layer_norm",))
_reg("GroupNorm", _group_norm)
_reg("InstanceNorm", _instance_norm)
_reg("L2Normalization", _l2_normalization)
_reg("LRN", _lrn)
_reg("softmax", _softmax)
_reg("log_softmax", _log_softmax_op)
_reg("softmin", lambda x, axis=-1: torch.softmax(-x, dim=axis))
_reg("softmax_cross_entropy", _softmax_cross_entropy)
_reg("SoftmaxOutput", _softmax_output, ("softmax_output",))
_reg("Activation", _activation_op, ("activation",))
_reg("LeakyReLU", _leaky_relu, needs_rng=True, needs_train=True)
_reg("Dropout", _dropout_op, ("dropout",), needs_rng=True, needs_train=True)
_reg("Embedding", _embedding_op, ("embedding",))
_reg("_contrib_SparseEmbedding", lambda data, weight, **kw: _embedding_op(
    data, weight, **{k: v for k, v in kw.items() if k != "sparse_grad"}))
_reg("CTCLoss", _ctc_loss, ("ctc_loss",))
_reg("_contrib_BatchNormWithReLU", _batch_norm_with_relu, nout=3,
     needs_train=True)
_reg("_contrib_SyncBatchNorm", _sync_batch_norm, needs_train=True)
_reg("Correlation", _correlation)
_reg("pick", _pick_op)

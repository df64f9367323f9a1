"""Shape, indexing and ordering ops (the port of
``mxnet_tpu/ops/shape_ops.py``).

Reshape's special codes live here once (:func:`infer_reshape`, the
reference's ``ReshapeParam``): 0 copies the input dim, -1 infers one,
-2 copies all remaining, -3 merges the next two, -4 splits the next dim
by the following two values. ``NDArray.reshape`` calls it. Index inputs
may arrive as floats and are truncated, as the reference's
``astype(int32)``. ``pick`` is registered with the other functions gluon
calls, in :mod:`.nn`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..base import torch_dtype
from .registry import _REGISTRY, Operator, alias

__all__ = ["infer_reshape"]


def _reg(name, fn, differentiable=True, nout=1, variadic=False):
    _REGISTRY[name] = Operator(name, fn, nout=nout,
                               differentiable=differentiable,
                               variadic=variadic)


def infer_reshape(src_shape, target):
    """Resolve a reference-style reshape spec against a concrete shape."""
    src = list(src_shape)
    out = []
    i = 0
    t = list(target)
    k = 0
    while k < len(t):
        d = t[k]
        if d == 0:
            out.append(src[i])
            i += 1
        elif d == -1:
            out.append(-1)
            i += 1
        elif d == -2:
            out.extend(src[i:])
            i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif d == -4:
            a, b = t[k + 1], t[k + 2]
            sz = src[i]
            if a == -1:
                a = sz // b
            if b == -1:
                b = sz // a
            out.extend([a, b])
            i += 1
            k += 2
        else:
            out.append(d)
            if i < len(src):
                i += 1
        k += 1
    if out.count(-1):
        known = 1
        for d in out:
            if d != -1:
                known *= d
        total = 1
        for d in src_shape:
            total *= d
        out[out.index(-1)] = total // max(known, 1)
    return tuple(out)


def _idx(t):
    return t.long()


def _reshape(x, shape=None, reverse=False):
    return torch.reshape(x, infer_reshape(x.shape, shape))


_reg("reshape", _reshape)
alias("Reshape", "reshape")
_reg("reshape_like", lambda x, y: torch.reshape(x, y.shape))


def _transpose(x, axes=None):
    if not axes:
        return x.permute(*reversed(range(x.ndim)))
    return x.permute(*axes)


_reg("transpose", _transpose)
_reg("swapaxes", lambda x, dim1=0, dim2=0: torch.swapaxes(x, dim1, dim2))
alias("SwapAxis", "swapaxes")
_reg("flatten", lambda x: torch.reshape(x, (x.shape[0], -1)))
alias("Flatten", "flatten")
_reg("expand_dims", lambda x, axis: torch.unsqueeze(
    x, axis if axis >= 0 else axis + x.ndim + 1))


def _squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, axis)


_reg("squeeze", _squeeze)


def _broadcast_to(x, shape):
    # reference semantics: 0 in the target keeps the source dim
    tgt = tuple(s if t == 0 else t for s, t in zip(x.shape, shape)) \
        if len(shape) == x.ndim else tuple(shape)
    return torch.broadcast_to(x, tgt)


_reg("broadcast_to", _broadcast_to)
_reg("broadcast_like", lambda x, y: torch.broadcast_to(x, y.shape))


def _broadcast_axis(x, axis=(), size=()):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    size = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(x.shape)
    for a, s in zip(axis, size):
        tgt[a] = s
    return torch.broadcast_to(x, tuple(tgt))


_reg("broadcast_axis", _broadcast_axis)
alias("broadcast_axes", "broadcast_axis")
_reg("tile", lambda x, reps: torch.tile(
    x, tuple(reps) if isinstance(reps, (tuple, list)) else (reps,)))


def _repeat(x, repeats, axis=None):
    if axis is None:
        return torch.repeat_interleave(x.reshape(-1), repeats)
    return torch.repeat_interleave(x, repeats, dim=axis)


_reg("repeat", _repeat)


def _flip(x, axis):
    return torch.flip(x, (axis,) if isinstance(axis, int) else tuple(axis))


_reg("flip", _flip)
alias("reverse", "flip")


def _pad_index(n, before, after, mode, device):
    """Source indices of one padded axis (numpy's ``pad`` of an
    ``arange``)."""
    idx = np.pad(np.arange(n), (before, after), mode=mode)
    return torch.from_numpy(idx).to(device)


def _pad(x, mode="constant", pad_width=(), constant_value=0):
    pw = [(pad_width[2 * i], pad_width[2 * i + 1]) for i in range(x.ndim)]
    if mode == "constant":
        flat = [p for pair in reversed(pw) for p in pair]
        return F.pad(x, flat, mode="constant", value=constant_value)
    np_mode = {"edge": "edge", "reflect": "reflect"}[mode]
    for ax, (b, a) in enumerate(pw):
        if b or a:
            x = torch.index_select(
                x, ax, _pad_index(x.shape[ax], b, a, np_mode, x.device))
    return x


_reg("pad", _pad)
alias("Pad", "pad")
_reg("concat", lambda xs, dim=1, num_args=None: torch.cat(xs, dim=dim),
     variadic=True)
alias("Concat", "concat")
_reg("stack", lambda xs, axis=0, num_args=None: torch.stack(xs, dim=axis),
     variadic=True)


def _split(x, num_outputs=None, axis=1, squeeze_axis=False, sections=None):
    n = num_outputs or sections
    parts = torch.tensor_split(x, n, dim=axis)
    if squeeze_axis:
        parts = [torch.squeeze(p, axis) for p in parts]
    return tuple(parts)


_reg("split", _split, nout=-1)
alias("SliceChannel", "split")


def _slice(x, begin, end, step=None):
    step = step or [None] * len(begin)
    idx = []
    for ax, (b, e, s) in enumerate(zip(begin, end, step)):
        if s is not None and s < 0:
            # a negative step: numpy's slice of the flipped axis
            n = x.shape[ax]
            sel = np.arange(n)[slice(b, e, s)].copy()
            x = torch.index_select(x, ax, torch.from_numpy(sel).to(x.device))
            idx.append(slice(None))
        else:
            idx.append(slice(b, e, s))
    return x[tuple(idx)]


_reg("slice", _slice)


def _slice_axis(x, axis, begin, end):
    idx = [slice(None)] * x.ndim
    if end is None:
        end = x.shape[axis]
    idx[axis] = slice(begin, end)
    return x[tuple(idx)]


_reg("slice_axis", _slice_axis)


def _slice_like(x, y, axes=()):
    axes = tuple(axes) if axes else tuple(range(min(x.ndim, y.ndim)))
    idx = [slice(None)] * x.ndim
    for a in axes:
        idx[a] = slice(0, y.shape[a])
    return x[tuple(idx)]


_reg("slice_like", _slice_like)
_reg("clip", lambda x, a_min=None, a_max=None: torch.clamp(x, a_min, a_max))


def _take(x, indices, axis=0, mode="clip"):
    idx = _idx(indices)
    n = x.shape[axis]
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.index_select(x, axis, idx.reshape(-1))
    ax = axis % x.ndim
    return out.reshape(x.shape[:ax] + idx.shape + x.shape[ax + 1:])


_reg("take", _take)
_reg("batch_take", lambda x, indices: x[
    torch.arange(x.shape[0], device=x.device), _idx(indices)])


def _gather_nd(x, indices):
    ind = _idx(indices)
    return x[tuple(ind[i] for i in range(ind.shape[0]))]


_reg("gather_nd", _gather_nd)


def _scatter_nd(data, indices, shape):
    ind = _idx(indices)
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(ind[i] for i in range(ind.shape[0])), data)


_reg("scatter_nd", _scatter_nd)


def _one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    d = torch_dtype(dtype)
    hit = _idx(indices).unsqueeze(-1) == torch.arange(depth,
                                                      device=indices.device)
    return torch.where(hit, torch.full((), on_value, dtype=d,
                                       device=indices.device),
                       torch.full((), off_value, dtype=d,
                                  device=indices.device))


_reg("one_hot", _one_hot, differentiable=False)


def _sort(x, axis=-1, is_ascend=True):
    out = torch.sort(x, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


_reg("sort", _sort)


def _argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    out = torch.argsort(x, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(torch_dtype(dtype))


_reg("argsort", _argsort, differentiable=False)


# the integer type whose order of a float's bits, after
# :func:`_total_order`, is IEEE totalOrder
_BITS = {torch.float64: torch.int64, torch.float32: torch.int32,
         torch.float16: torch.int16, torch.bfloat16: torch.int16}


def _total_order(x):
    """Integers that sort as ``lax.top_k`` compares floats: IEEE
    totalOrder (-NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN);
    integers as they are."""
    bits = _BITS.get(x.dtype)
    if bits is None:
        return x
    b = x.contiguous().view(bits)
    return torch.where(b < 0, b ^ torch.iinfo(bits).max, b)


def _topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    # lax.top_k of x (of -x for is_ascend): a stable sort, descending,
    # then a slice, so the lower index comes first among equal keys
    # (torch.topk promises no order among ties). -x reverses the
    # totalOrder of floats, so is_ascend takes ~key (the card's negation
    # need not flip a NaN's sign bit)
    ax = axis % x.ndim
    key = _total_order(x)
    if is_ascend:
        key = ~key if x.is_floating_point() else -x
    idx = torch.sort(key, dim=ax, descending=True,
                     stable=True).indices.narrow(ax, 0, k)
    vals = torch.gather(x, ax, idx)
    idx = idx.to(torch_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idx
    if ret_typ == "both":
        return vals, idx
    raise NotImplementedError(f"topk ret_typ={ret_typ!r}")


_reg("topk", _topk, nout=-1, differentiable=False)
_reg("shape_array", lambda x: torch.tensor(x.shape, dtype=torch.int32,
                                           device=x.device),
     differentiable=False)
_reg("size_array", lambda x: torch.tensor([x.numel()], dtype=torch.int32,
                                          device=x.device),
     differentiable=False)
_reg("cast", lambda x, dtype: x.to(torch_dtype(dtype)))
alias("Cast", "cast")


def _diag(x, k=0):
    if x.ndim == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=-2, dim2=-1)


_reg("diag", _diag)


def _depth_to_space(x, block_size):
    b, c, h, w = x.shape
    bs = block_size
    y = x.reshape(b, bs, bs, c // (bs * bs), h, w)
    y = y.permute(0, 3, 4, 1, 5, 2)
    return y.reshape(b, c // (bs * bs), h * bs, w * bs)


def _space_to_depth(x, block_size):
    b, c, h, w = x.shape
    bs = block_size
    y = x.reshape(b, c, h // bs, bs, w // bs, bs)
    y = y.permute(0, 3, 5, 1, 2, 4)
    return y.reshape(b, c * bs * bs, h // bs, w // bs)


_reg("depth_to_space", _depth_to_space)
_reg("space_to_depth", _space_to_depth)


# --- sequence ops (layout (seq_len, batch, ...)) -----------------------------
def _steps(x):
    return torch.arange(x.shape[0], device=x.device)[:, None]


def _sequence_mask(x, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return x
    if axis == 1:
        x = torch.swapaxes(x, 0, 1)
    mask = _steps(x) < sequence_length[None, :]
    mask = mask.reshape(mask.shape + (1,) * (x.ndim - 2))
    out = torch.where(mask, x, torch.full((), value, dtype=x.dtype,
                                          device=x.device))
    return torch.swapaxes(out, 0, 1) if axis == 1 else out


def _sequence_last(x, sequence_length=None, use_sequence_length=False,
                   axis=0):
    if axis == 1:
        x = torch.swapaxes(x, 0, 1)
    if not use_sequence_length or sequence_length is None:
        return x[-1]
    idx = _idx(sequence_length) - 1
    idx = idx.reshape((1, -1) + (1,) * (x.ndim - 2)).expand(
        (1,) + x.shape[1:])
    return torch.gather(x, 0, idx)[0]


def _sequence_reverse(x, sequence_length=None, use_sequence_length=False,
                      axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(x, (0,))
    steps = _steps(x)
    lens = _idx(sequence_length)[None, :]
    src = torch.where(steps < lens, lens - 1 - steps, steps)
    src = src.reshape(src.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    return torch.gather(x, 0, src)


_reg("SequenceMask", _sequence_mask)
alias("sequence_mask", "SequenceMask")
_reg("SequenceLast", _sequence_last)
alias("sequence_last", "SequenceLast")
_reg("SequenceReverse", _sequence_reverse)
alias("sequence_reverse", "SequenceReverse")


# ------------------------------------------------------- creation ops ------
# ``ctx`` places the result (default: the card), as nd.zeros does
def _dev(ctx):
    return resolve_device(ctx)


def _zeros_impl(shape=(), dtype="float32", ctx=None):
    return torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                       device=_dev(ctx))


def _ones_impl(shape=(), dtype="float32", ctx=None):
    return torch.ones(tuple(shape), dtype=torch_dtype(dtype),
                      device=_dev(ctx))


def _full_impl(shape=(), value=0.0, dtype="float32", ctx=None):
    return torch.full(tuple(shape), value, dtype=torch_dtype(dtype),
                      device=_dev(ctx))


def _arange_impl(start=0.0, stop=None, step=1.0, repeat=1, ctx=None,
                 dtype="float32"):
    if stop is None:
        start, stop = 0.0, start
    # numpy's length and values (start + i * step), as jnp.arange's
    vals = np.arange(start, stop, step).astype(np.float64)
    out = torch.from_numpy(vals).to(torch_dtype(dtype)).to(_dev(ctx))
    if repeat != 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out


def _eye_impl(N=0, M=0, k=0, dtype="float32", ctx=None):
    n, m = int(N), int(M) or int(N)
    rows = torch.arange(n, device=_dev(ctx))[:, None]
    cols = torch.arange(m, device=_dev(ctx))[None, :]
    return (cols - rows == int(k)).to(torch_dtype(dtype))


for _n, _f in (("_zeros", _zeros_impl), ("_ones", _ones_impl),
               ("_full", _full_impl), ("_arange", _arange_impl),
               ("_eye", _eye_impl)):
    _reg(_n, _f, differentiable=False)

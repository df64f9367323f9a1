"""``nd``: the imperative array API of the port (mirrors
``mxnet_tpu/ndarray``): the :class:`NDArray` class, the creation
functions (``array``, ``zeros``, ``ones``, ``full``, ``empty``,
``arange``, ``linspace``, ``eye``), ``concatenate``, ``waitall``,
``imperative_invoke``, ``save``/``load`` (the reference's ``MXTPU1``
container, byte for byte), the op namespace generated from the registry
(every op of :mod:`mxnet_tpu_torch.ops`, and those
:mod:`mxnet_tpu_torch.rtc` registers at run time), and the
sub-namespaces ``nd.random``, ``nd.linalg`` (``nd.linalg.gemm2`` is
``_linalg_gemm2``), ``nd.op``, ``nd.contrib`` (``foreach``,
``while_loop``, ``cond``; ``nd.contrib.box_nms`` is ``_contrib_box_nms``)
and ``nd.sparse`` (the row-sparse and CSR storage types).

Every function here returns NDArrays (see :mod:`.ndarray`). ``ctx`` is
``"cpu"``, ``"cuda"`` or a ``torch.device``; it defaults to the card and
raises without CUDA unless ``ctx="cpu"``.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from .. import ops as _ops  # noqa: F401  (registers the ported ops)
from .._device import resolve_device
from ..base import dtype_code, dtype_name, torch_dtype
from ..context import Context, current_context  # noqa: F401  (nd.Context)
from ..error import CheckpointCorruptError
from ..ops.invoke import apply_op
from . import register as _register
from .ndarray import NDArray

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "linspace", "eye", "concatenate", "waitall", "imperative_invoke",
           "save", "load"]


def _device(ctx):
    return resolve_device(ctx)


def _dtype(dtype):
    return None if dtype is None else torch_dtype(dtype)


def array(source_array, ctx=None, dtype=None):
    """An NDArray on ``ctx`` holding a copy of ``source_array``: numpy
    arrays, tensors and NDArrays keep their dtype (float64 becomes
    float32), anything else defaults to float32."""
    dev = _device(ctx)
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if isinstance(source_array, torch.Tensor):
        # a copy, as the reference's: the array does not alias its source
        t = source_array.detach().clone()
    else:
        if dtype is None and not isinstance(source_array, np.ndarray):
            dtype = np.float32
        t = torch.from_numpy(np.array(source_array))
    if dtype is None and t.dtype == torch.float64:
        dtype = np.float32
    return NDArray(t.to(device=dev, dtype=_dtype(dtype)))


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype="float32"):
    return NDArray(torch.zeros(_shape(shape), dtype=_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype="float32"):
    return NDArray(torch.ones(_shape(shape), dtype=_dtype(dtype),
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype="float32"):
    return NDArray(torch.full(_shape(shape), val, dtype=_dtype(dtype),
                              device=_device(ctx)))


def empty(shape, ctx=None, dtype="float32"):
    """A zeroed array, as the reference's (its buffers are initialised)."""
    return zeros(shape, ctx, dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    return NDArray(apply_op("_arange", [], {
        "start": start, "stop": stop, "step": step, "repeat": repeat,
        "ctx": _device(ctx), "dtype": dtype}))


def linspace(start, stop, num, endpoint=True, ctx=None, dtype="float32"):
    vals = np.linspace(start, stop, num, endpoint=endpoint)
    return NDArray(torch.from_numpy(vals).to(device=_device(ctx),
                                             dtype=_dtype(dtype)))


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    return NDArray(apply_op("_eye", [], {"N": N, "M": M, "k": k,
                                         "ctx": _device(ctx),
                                         "dtype": dtype}))


def concatenate(arrays, axis=0, always_copy=True):
    return NDArray(apply_op("concat", list(arrays), {"dim": axis}))


def imperative_invoke(op_name, *args, **kwargs):
    """Invoke the registered op ``op_name`` on the arrays among ``args``
    (the reference's ``MXImperativeInvokeEx``)."""
    from .ndarray import _wrap
    arrays = [a for a in args if isinstance(a, (NDArray, torch.Tensor))]
    return _wrap(apply_op(op_name, arrays, kwargs))


def waitall():
    """Wait for all pending work on the card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ------------------------------------------------------------ save/load ----

_MAGIC = 0x4D585450_55313100  # "MXTPU1" tag
# the reference's devtype codes (include/mxnet/base.h: kCPU=1, kGPU=2)
_DEVTYPE = {"cpu": 1, "cuda": 2}


def _host(arr):
    """(torch dtype, shape, raw bytes, devtype code) of one array: an
    NDArray or a tensor on any device (copied to the host) or anything
    numpy takes."""
    if isinstance(arr, NDArray):
        arr = arr._data
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        dev = _DEVTYPE["cuda" if t.is_cuda else "cpu"]
        t = t.cpu().contiguous()
        if t.dtype == torch.bfloat16:       # numpy cannot name it
            raw = t.view(torch.int16).numpy().tobytes()
        else:
            raw = t.numpy().tobytes()
        return t.dtype, tuple(t.shape), raw, dev
    a = np.ascontiguousarray(arr)
    return torch_dtype(a.dtype), a.shape, a.tobytes(), _DEVTYPE["cpu"]


def save(fname: str, data):
    """Save arrays to a binary container, atomically.

    Format (the reference's ``MXTPU1``, little-endian): magic u64, count
    u64, then per array: name (u32 length + utf8), dtype code u32 (the
    reference's codes, :mod:`mxnet_tpu_torch.base`), ctx devtype u32 (1
    host, 2 a CUDA tensor), ndim u32, shape i64 each, nbytes u64, raw
    buffer. ``data`` is a dict of named arrays, a list of unnamed ones
    or one array; arrays are NDArrays or tensors on any device, or host
    numpy. For
    host inputs the file is the reference's for the same arrays, byte
    for byte.

    The write goes through ``resilience.atomic.atomic_write`` (temp file
    + fsync + rename): a crash at any byte leaves the previous file or
    none at ``fname``, never a torn container. Returns the metadata dict
    of checkpoint manifests::

        {"crc32": <whole-file crc>, "nbytes": <file size>,
         "arrays": {name: {"crc32", "nbytes", "shape", "dtype"}}}
    """
    from ..resilience.atomic import atomic_write
    if isinstance(data, (NDArray, torch.Tensor, np.ndarray)):
        items = [("", data)]
    elif isinstance(data, dict):
        items = list(data.items())
    else:
        items = [("", d) for d in data]
    arrays_meta = {}
    with atomic_write(fname) as f:
        f.write(struct.pack("<QQ", _MAGIC, len(items)))
        for i, (name, arr) in enumerate(items):
            nb = name.encode()
            dtype, shape, raw, dev = _host(arr)
            f.write(struct.pack("<I", len(nb)))
            f.write(nb)
            f.write(struct.pack("<III", dtype_code(dtype), dev,
                                len(shape)))
            f.write(struct.pack(f"<{len(shape)}q", *shape))
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
            arrays_meta[name or f"__{i}"] = {
                "crc32": zlib.crc32(raw), "nbytes": len(raw),
                "shape": list(shape), "dtype": dtype_name(dtype)}
    return {"crc32": f.crc32, "nbytes": f.nbytes, "arrays": arrays_meta}


def _read_exact(f, n, fname):
    buf = f.read(n)
    if len(buf) != n:
        raise CheckpointCorruptError(
            f"{fname}: truncated NDArray container "
            f"(wanted {n} bytes, got {len(buf)})")
    return buf


def _from_bytes(raw, dtype, shape):
    """A CPU tensor of ``dtype`` and ``shape`` over a copy of ``raw``."""
    n = 1
    for s in shape:
        n *= s
    if n * torch.empty((), dtype=dtype).element_size() != len(raw):
        raise ValueError(f"{len(raw)} bytes do not hold {shape} of "
                         f"{dtype}")
    if not raw:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(shape)


def load(fname: str, manifest=None, device=None):
    """Load a container saved by :func:`save` (or by the reference's
    ``nd.save``): a dict of NDArrays by name, or a list when no array is
    named, as the reference's. They land on the CPU unless ``device`` is
    given. ``manifest`` as :func:`load_tensors`'s."""
    loaded = load_tensors(fname, manifest, device)
    if isinstance(loaded, dict):
        return {k: NDArray(v) for k, v in loaded.items()}
    return [NDArray(v) for v in loaded]


def load_tensors(fname: str, manifest=None, device=None):
    """:func:`load` returning tensors (the checkpoint stack's loader):
    a dict of tensors by name, or a list when no array is named.
    Tensors land on the CPU unless ``device`` is given.

    ``manifest`` (optional) is the ``"arrays"`` metadata :func:`save`
    returned: each array's raw buffer is then CRC32-checked against it.
    A mismatch, a bad magic, a truncated or malformed file raise
    :class:`~mxnet_tpu_torch.error.CheckpointCorruptError`, so callers
    can route corruption to recovery."""
    dev = None if device is None else resolve_device(device)
    with open(fname, "rb") as f:
        magic, count = struct.unpack("<QQ", _read_exact(f, 16, fname))
        if magic != _MAGIC:
            raise CheckpointCorruptError(
                f"{fname}: not an mxnet_tpu NDArray file "
                f"(bad magic 0x{magic:016x})")
        named, unnamed = {}, []
        for i in range(count):
            try:
                (nlen,) = struct.unpack("<I", _read_exact(f, 4, fname))
                name = _read_exact(f, nlen, fname).decode()
                dcode, _ctx, ndim = struct.unpack(
                    "<III", _read_exact(f, 12, fname))
                shape = struct.unpack(
                    f"<{ndim}q", _read_exact(f, 8 * ndim, fname))
                (nb,) = struct.unpack("<Q", _read_exact(f, 8, fname))
                raw = _read_exact(f, nb, fname)
                t = _from_bytes(raw, torch_dtype(dcode), shape)
            except CheckpointCorruptError:
                raise
            except (struct.error, KeyError, UnicodeDecodeError,
                    ValueError, RuntimeError) as exc:
                raise CheckpointCorruptError(
                    f"{fname}: malformed array record #{i}: "
                    f"{exc!r}") from exc
            if manifest is not None:
                want = manifest.get(name or f"__{i}")
                if want is not None and \
                        zlib.crc32(raw) != int(want["crc32"]):
                    raise CheckpointCorruptError(
                        f"{fname}: CRC mismatch for array "
                        f"'{name or f'__{i}'}' — checkpoint is corrupt")
            if dev is not None:
                t = t.to(dev)
            if name:
                named[name] = t
            else:
                unnamed.append(t)
        return named if named else unnamed


_register.populate(globals())


class _SubNamespace:
    """Attribute view over the registry ops a name maps to."""

    def __init__(self, names):
        self._names = names

    def __getattr__(self, item):
        from ..ops.registry import _REGISTRY
        for cand in self._names(item):
            if cand in _REGISTRY:
                return _register.make_op_func(_REGISTRY[cand])
        raise AttributeError(item)


linalg = _SubNamespace(lambda n: (f"_linalg_{n}", f"linalg_{n}", n))
op = _SubNamespace(lambda n: (n,))
from . import random  # noqa: E402,F401  (nd.random)
# nd.contrib: foreach, while_loop, cond and the _contrib_* ops by their
# short names (the module's __getattr__)
from . import contrib  # noqa: E402,F401
# nd.sparse: the row-sparse and CSR storage types
from . import sparse  # noqa: E402,F401

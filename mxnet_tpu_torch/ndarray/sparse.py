"""Sparse storage types of the port (mirrors ``mxnet_tpu/ndarray/sparse.py``):
``nd.sparse``.

A :class:`RowSparseNDArray` holds ``values`` (one row a stored row) and
their row ``indices`` in a dense array of ``shape``; a :class:`CSRNDArray`
holds a matrix's ``data``, column ``indices`` and row pointers
``indptr``. Storage is lazy, as in the reference: the dense form is made
only when an op that is not sparse-aware reads the array (``_data``, the
attribute every op unwraps through ``apply_op``), and is then kept
(``densified``). The sparse-aware paths read ``indices``/``data`` and
never densify: the optimizers' lazy updates, the kvstore, :func:`dot`,
:func:`add` and :func:`retain`.

A row-sparse array may list a row more than once (a gradient of two
lookups of one id); its dense form sums the repeats, in a fixed order
(:func:`summed_rows`: no atomics, so the card repeats its bits and
gives the CPU's). Indices are int64 (torch indexes with them; the
reference keeps int32).

The functions are the reference's: :func:`row_sparse_array`,
:func:`csr_matrix`, :func:`zeros`, :func:`cast_storage`, :func:`retain`,
:func:`dot` (CSR times a dense matrix or vector, as a gather and a sum
over each output row, differentiable with respect to the dense side)
and :func:`add`. Their ``ctx`` defaults to the card, as ``nd.array``'s;
arrays built from tensors keep the tensors' device.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..base import torch_dtype
from .ndarray import NDArray, numpy_dtype

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "cast_storage", "retain",
           "dot", "add", "zeros", "summed_rows"]


def _tensor(x, device, dtype=None):
    """``x`` (an NDArray, tensor or array-like) as a tensor on ``device``
    (a tensor keeps its own device when ``device`` is None)."""
    if isinstance(x, NDArray):
        x = x._data
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
        if device is None:
            device = resolve_device()
    if device is not None:
        x = x.to(device)
    return x if dtype is None else x.to(dtype)


def summed_rows(indices, values):
    """(the ids each once, sorted; each id's rows summed). The sum's
    order is fixed: a stable sort of the ids keeps each id's rows in the
    order they came, and each run is summed in that order (a segment
    sum, one thread a run). ``torch.unique_consecutive`` reads the run
    count on the host (a sync on the card)."""
    if indices.numel() == 0:
        return indices, values
    order = torch.argsort(indices, stable=True)
    rows, counts = torch.unique_consecutive(indices[order],
                                            return_counts=True)
    return rows, torch.segment_reduce(values[order], "sum", lengths=counts,
                                      axis=0)


def _ctx_device(ctx, *parts):
    """The device to build on: ``ctx`` when given, else the device of the
    first tensor (or NDArray) among ``parts``, else None (the card)."""
    if ctx is not None:
        return resolve_device(ctx)
    for p in parts:
        if isinstance(p, NDArray):
            return p._data.device
        if isinstance(p, torch.Tensor):
            return p.device
    return None


class BaseSparseNDArray(NDArray):
    """The lazy dense form: ``_data`` is made from the sparse parts at its
    first read and kept; assigning ``_data`` (an in-place op) makes the
    dense form the array's value."""

    __slots__ = ("_dense",)

    def _init_base(self):
        # NDArray.__init__ is bypassed: there is no dense tensor yet
        self._dense = None
        self._grad = None
        self._grad_req = "null"

    def _densify(self):
        raise NotImplementedError

    @property
    def _data(self):
        if self._dense is None:
            self._dense = self._densify()
        return self._dense

    @_data.setter
    def _data(self, value):
        self._dense = value

    @property
    def densified(self):
        """True once the dense form has been made."""
        return self._dense is not None

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def context(self):
        """The array's device as a Context."""
        from ..context import device
        return device(self._values.device)

    ctx = context

    @property
    def dtype(self):
        return numpy_dtype(self._values.dtype)

    @property
    def shape(self):
        return self._sshape

    def wait_to_read(self):
        if self._values.is_cuda:
            torch.cuda.current_stream(self._values.device).synchronize()


class RowSparseNDArray(BaseSparseNDArray):
    """Row-sparse array: ``values[i]`` is row ``indices[i]`` of a dense
    array of ``shape``; every other row is zero."""

    __slots__ = ("_indices", "_values", "_sshape")

    def __init__(self, values, indices, shape=None, ctx=None):
        dev = _ctx_device(ctx, values, indices)
        vals = _tensor(values, dev)
        idx = _tensor(indices, vals.device, torch.int64).reshape(-1)
        if shape is None:
            first = int(idx.max()) + 1 if idx.numel() else 0
            shape = (first,) + tuple(vals.shape[1:])
        self._init_base()
        self._indices = idx
        self._values = vals
        self._sshape = tuple(int(s) for s in shape)

    @classmethod
    def from_coo(cls, t):
        """A hybrid COO tensor's (sparse dim 1) ids and rows, as they
        stand (not coalesced)."""
        return cls(t._values(), t._indices()[0], tuple(t.shape))

    def _densify(self):
        rows, vals = summed_rows(self._indices, self._values)
        return torch.zeros(self._sshape, dtype=self._values.dtype,
                           device=self._values.device).index_copy_(
            0, rows, vals)

    @property
    def stype(self):
        return "row_sparse"

    @property
    def indices(self):
        return NDArray(self._indices)

    @property
    def data(self):
        return NDArray(self._values)

    def tostype(self, stype):
        if stype == "default":
            return NDArray(self._data)
        if stype == "row_sparse":
            return self
        if stype == "csr" and len(self._sshape) == 2:
            return cast_storage(NDArray(self._data), "csr")
        raise ValueError(f"cannot cast row_sparse to {stype}")

    def retain(self, row_ids):
        return retain(self, row_ids)

    def copyto(self, other):
        if isinstance(other, NDArray):
            return NDArray.copyto(NDArray(self._data), other)
        dev = resolve_device(other)
        return RowSparseNDArray(self._values.to(dev), self._indices.to(dev),
                                self._sshape)

    def __repr__(self):
        return (f"\n<RowSparseNDArray {self._sshape} "
                f"nnz-rows={int(self._indices.shape[0])}>")


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse row matrix."""

    __slots__ = ("_indptr", "_indices", "_values", "_sshape")

    def __init__(self, data, indptr, indices, shape, ctx=None):
        dev = _ctx_device(ctx, data, indptr, indices)
        vals = _tensor(data, dev)
        self._init_base()
        self._indptr = _tensor(indptr, vals.device, torch.int64)
        self._indices = _tensor(indices, vals.device, torch.int64)
        self._values = vals
        self._sshape = tuple(int(s) for s in shape)

    def _row_ids(self):
        """Each stored value's row, from the run lengths of ``indptr``
        (no host read: the total is the values' count)."""
        counts = torch.diff(self._indptr)
        return torch.repeat_interleave(
            torch.arange(self._sshape[0], device=self._values.device),
            counts, output_size=self._values.shape[0])

    def _densify(self):
        out = torch.zeros(self._sshape, dtype=self._values.dtype,
                          device=self._values.device)
        return out.index_put_((self._row_ids(), self._indices),
                              self._values, accumulate=True)

    @property
    def stype(self):
        return "csr"

    @property
    def indptr(self):
        return NDArray(self._indptr)

    @property
    def indices(self):
        return NDArray(self._indices)

    @property
    def data(self):
        return NDArray(self._values)

    def tostype(self, stype):
        if stype == "default":
            return NDArray(self._data)
        if stype == "csr":
            return self
        raise ValueError(f"cannot cast csr to {stype}")

    def __repr__(self):
        return (f"\n<CSRNDArray {self._sshape} "
                f"nnz={int(self._values.shape[0])}>")


# ---------------------------------------------------------- construct ----
def _host_dense(arg1, dtype):
    dense = arg1.asnumpy() if isinstance(arg1, NDArray) else np.asarray(arg1)
    if dtype is not None:
        dense = dense.astype(np.dtype(dtype))
    return dense


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(values, indices)`` or from a dense
    source (its nonzero rows)."""
    if isinstance(arg1, RowSparseNDArray):
        return arg1
    if isinstance(arg1, tuple) and len(arg1) == 2 \
            and not np.isscalar(arg1[0]):
        values, indices = arg1
        return RowSparseNDArray(values, indices, shape, ctx=ctx)
    dev = _ctx_device(ctx, arg1)
    dense = _host_dense(arg1, dtype)
    nz = np.where(np.any(dense.reshape(dense.shape[0], -1) != 0, axis=1))[0]
    return RowSparseNDArray(dense[nz], nz, dense.shape,
                            ctx=dev if dev is not None else "cuda")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` or from a dense
    source."""
    if isinstance(arg1, CSRNDArray):
        return arg1
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        return CSRNDArray(data, indptr, indices, shape, ctx=ctx)
    dev = _ctx_device(ctx, arg1)
    dense = _host_dense(arg1, dtype)
    mask = dense != 0
    indptr = np.concatenate([[0], np.cumsum(mask.sum(axis=1))])
    return CSRNDArray(dense[mask], indptr, np.nonzero(mask)[1], dense.shape,
                      ctx=dev if dev is not None else "cuda")


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero array of storage type ``stype``."""
    dev = resolve_device(ctx)
    dt = torch_dtype(dtype or "float32")
    shape = tuple(shape)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + shape[1:], dtype=dt, device=dev),
            torch.zeros((0,), dtype=torch.int64, device=dev), shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=torch.int64,
                                      device=dev),
                          torch.zeros((0,), dtype=torch.int64, device=dev),
                          shape)
    return NDArray(torch.zeros(shape, dtype=dt, device=dev))


# ------------------------------------------------------------- compute ----
def cast_storage(arr, stype):
    """``arr`` in storage type ``stype``."""
    if stype == "default":
        return NDArray(arr._data)
    if stype == "row_sparse":
        return row_sparse_array(arr)
    if stype == "csr":
        return csr_matrix(arr)
    raise ValueError(stype)


def retain(rsp, row_ids):
    """``rsp`` with the values of the rows not in ``row_ids`` zeroed (its
    indices as they were)."""
    if not isinstance(rsp, RowSparseNDArray):
        raise TypeError("retain expects a RowSparseNDArray")
    ids = _tensor(row_ids, rsp._indices.device, torch.int64).reshape(-1)
    keep = torch.isin(rsp._indices, ids)
    vals = torch.where(keep.reshape((-1,) + (1,) * (rsp._values.ndim - 1)),
                       rsp._values, torch.zeros((), dtype=rsp._values.dtype,
                                                device=rsp._values.device))
    return RowSparseNDArray(vals, rsp._indices, rsp._sshape)


def _csr_dot(lhs, dense, transpose_a):
    """``lhs @ dense`` (``lhs.T @ dense`` with ``transpose_a``) over the
    stored values: each value times the row of ``dense`` its column (its
    row) names, summed into its row (its column) of the output."""
    rows, cols, vals = lhs._row_ids(), lhs._indices, lhs._values
    gather, scatter = (rows, cols) if transpose_a else (cols, rows)
    n_out = lhs._sshape[1] if transpose_a else lhs._sshape[0]
    picked = dense.index_select(0, gather)
    contrib = picked * (vals if dense.ndim == 1 else vals[:, None])
    out = torch.zeros((n_out,) + tuple(dense.shape[1:]), dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add(0, scatter, contrib)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse dot: a CSR left side takes :func:`_csr_dot` (autograd
    differentiates it with respect to the dense right side, as the
    reference's tape does); other operands go through the dense ``dot``
    op."""
    from ..ops.invoke import apply_op
    if isinstance(lhs, CSRNDArray) and not transpose_b:
        dense = rhs._data if isinstance(rhs, NDArray) else torch.as_tensor(
            rhs, device=lhs._values.device)
        return NDArray(_csr_dot(lhs, dense, transpose_a))
    return NDArray(apply_op("dot", [lhs, rhs], {"transpose_a": transpose_a,
                                                "transpose_b": transpose_b}))


def add(lhs, rhs):
    """``lhs + rhs``; two row-sparse arrays stay row-sparse (their ids
    and rows concatenated)."""
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs,
                                                        RowSparseNDArray):
        if lhs._sshape != rhs._sshape:
            raise ValueError("shape mismatch")
        return RowSparseNDArray(torch.cat([lhs._values, rhs._values]),
                                torch.cat([lhs._indices, rhs._indices]),
                                lhs._sshape)
    return NDArray(lhs._data + rhs._data)

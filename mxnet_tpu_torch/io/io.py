"""DataIter protocol + NDArrayIter of the port (mirrors
``mxnet_tpu/io/io.py``).

Reference: python/mxnet/io/io.py — DataDesc(:64), DataBatch(:115),
DataIter(:179), NDArrayIter(:490), MXDataIter(:799 — ctypes wrapper over
the C++ iterators). gluon.data.DataLoader is the heavy path;
NDArrayIter is kept because every legacy Module example feeds on it.
Batches are NDArrays on the iterator's context: that of its data (numpy
data goes to ``current_context()`` at construction, the card unless a
``with mx.cpu():`` block says otherwise), and a batch is gathered there,
with no host round trip. ``MXDataIter`` maps the reference's C++ iterator
names onto the port's: the record-file ones onto :mod:`..image`.
"""
from __future__ import annotations

import os
from collections import namedtuple, OrderedDict

import numpy as _np

import torch

from ..base import MXNetError
from ..context import current_context
from ..ndarray import NDArray, array as nd_array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "ResizeIter", "PrefetchingIter", "CSVIter", "LibSVMIter",
           "MXDataIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name+shape(+dtype/layout) of one input (reference: io.py:64)."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return f"DataDesc[{self.name},{self.shape},{self.dtype}," \
               f"{self.layout}]"

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """One mini-batch (reference: io.py:115)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), \
                "Data must be list of NDArrays"
        if label is not None:
            assert isinstance(label, (list, tuple)), \
                "Label must be list of NDArrays"
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        if self.label:
            label_shapes = [l.shape for l in self.label]
        else:
            label_shapes = None
        return f"{self.__class__.__name__}: data shapes: {data_shapes} " \
               f"label shapes: {label_shapes}"


class DataIter:
    """Abstract iterator (reference: io.py:179)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


def _init_data(data, allow_empty, default_name):
    """Normalize input to list of (name, NDArray) (reference:
    io.py:400 _init_data)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = OrderedDict([(default_name, data[0])])
        else:
            data = OrderedDict(
                [(f"_{i}_{default_name}", d) for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise TypeError(
            "Input must be NDArray, numpy.ndarray, a list of them or "
            "dict with them as values")
    for k, v in data.items():
        if not isinstance(v, NDArray):
            try:
                data[k] = nd_array(_np.asarray(v))
            except Exception:
                raise TypeError(f"Invalid type '{type(v)}' for {k}")
    return list(data.items())


class NDArrayIter(DataIter):
    """Iterator over in-memory arrays (reference: io.py:490)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = _np.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.num_data = self.idx.shape[0]
        self.cursor = -batch_size
        self._cache_data = None
        self._cache_label = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            _np.random.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                -self.batch_size < self.cursor < 0:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            # reference io.py: drop the trailing partial batch
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        return DataBatch(data=self.getdata(), label=self.getlabel(),
                         pad=self.getpad(), index=None)

    def _getdata(self, data_source):
        end = min(self.cursor + self.batch_size, self.num_data)
        sel = self.idx[max(self.cursor, 0):end]
        if len(sel) < self.batch_size and \
                self.last_batch_handle == "pad":
            pad = self.batch_size - len(sel)
            sel = _np.concatenate([sel, self.idx[:pad]])
        out = []
        for _, v in data_source:
            rows = torch.from_numpy(_np.asarray(sel, _np.int64)).to(
                v._data.device)
            out.append(NDArray(v._data.index_select(0, rows)))
        return out

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class ResizeIter(DataIter):
    """Resize an iterator's epoch length (reference: io.py:310)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Thread-prefetching wrapper (reference: io.py:367 — C++ prefetcher
    decorator src/io/iter_prefetcher.h).

    ``device_prefetch=True`` (or ``MXNET_TPU_DATA_PREFETCH`` set) also
    stages each prefetched batch onto the device from the worker thread,
    so the H2D copy overlaps the consumer's compute (the reference
    prefetcher's pinned staging)."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 device_prefetch=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.iters = iters
        assert len(iters) == 1, "composite prefetch not supported"
        self.provide_data = iters[0].provide_data
        self.provide_label = iters[0].provide_label
        self.batch_size = iters[0].batch_size
        if device_prefetch is None:
            from ..gluon.data.prefetch import default_prefetch_depth
            device_prefetch = default_prefetch_depth() > 0
        self._device_prefetch = bool(device_prefetch)
        self._queue = None
        self._worker = None
        self._stop = None
        self._start_worker()

    def _start_worker(self):
        import queue
        import threading
        q = queue.Queue(maxsize=2)
        stop = threading.Event()
        src = self.iters[0]
        do_stage = self._device_prefetch

        def worker():
            while not stop.is_set():
                try:
                    item = src.next()
                    if do_stage and item is not None:
                        from ..gluon.data.prefetch import stage_batch
                        item = stage_batch(item)
                except StopIteration:
                    item = None
                except BaseException as e:
                    # forward to the consumer (a dead producer with no
                    # sentinel would leave next() blocked forever)
                    item = e
                # bounded put that re-checks stop so reset() can't
                # deadlock/race with a blocked producer
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if item is None or isinstance(item, BaseException):
                    return

        self._queue, self._stop = q, stop
        self._worker = threading.Thread(target=worker, daemon=True)
        self._worker.start()

    def next(self):
        batch = self._queue.get()
        if batch is None:
            raise StopIteration
        if isinstance(batch, BaseException):
            raise batch
        return batch

    def reset(self):
        # stop + join the old worker BEFORE touching the underlying
        # iterator: exactly one producer at any time, no stale batches
        self._stop.set()
        import queue as _queue
        try:
            while True:
                self._queue.get_nowait()
        except _queue.Empty:
            pass
        self._worker.join(timeout=5)
        self.iters[0].reset()
        self._start_worker()


class CSVIter(NDArrayIter):
    """CSV file iterator (reference: src/io/iter_csv.cc registered as
    MXNET_REGISTER_IO_ITER(CSVIter); here backed by numpy loadtxt)."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=None, batch_size=1, **kwargs):
        data = _np.loadtxt(data_csv, delimiter=",",
                           dtype=_np.float32).reshape((-1,) +
                                                      tuple(data_shape))
        label = None
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",",
                                dtype=_np.float32)
            if label_shape:
                label = label.reshape((-1,) + tuple(label_shape))
        super().__init__(data, label, batch_size=batch_size, **kwargs)


def _parse_libsvm(path, with_label=True):
    """Parse one libsvm text file (or every file in a directory) into
    (labels list-of-float-lists, rows list-of-[(idx, val)...]).
    Zero-based, ascending indices (reference: src/io/iter_libsvm.cc:200
    — same convention, stricter than upstream libsvm's one-based)."""
    paths = [path]
    if os.path.isdir(path):
        paths = sorted(os.path.join(path, f) for f in os.listdir(path))
    labels, rows = [], []
    for p in paths:
        with open(p) as f:
            for lineno, line in enumerate(f, 1):
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split()
                feats_at = 0
                lab = []
                # leading non-"i:v" tokens are the inline label(s);
                # discarded when labels come from a separate file
                while feats_at < len(parts) and \
                        ":" not in parts[feats_at]:
                    lab.append(float(parts[feats_at]))
                    feats_at += 1
                if not with_label:
                    lab = []
                row, prev = [], -1
                for tok in parts[feats_at:]:
                    try:
                        i, v = tok.split(":", 1)
                        i = int(i)
                    except ValueError:
                        raise ValueError(
                            f"{p}:{lineno}: malformed libsvm token "
                            f"{tok!r}")
                    if i <= prev:
                        raise ValueError(
                            f"{p}:{lineno}: column indices must be "
                            f"zero-based and ascending (got {i} after "
                            f"{prev})")
                    prev = i
                    row.append((i, float(v)))
                labels.append(lab)
                rows.append(row)
    return labels, rows


class LibSVMIter(DataIter):
    """Sparse-data iterator over libsvm-format text files; batches come
    back as CSRNDArray (reference: src/io/iter_libsvm.cc:200
    ``MXNET_REGISTER_IO_ITER(LibSVMIter)``).

    ``data_libsvm`` may be a file or a directory (all files read, sorted).
    When ``label_libsvm`` is not given, labels are the leading dense
    values on each data line. Only ``round_batch=True`` semantics are
    supported, as in the reference: a final partial batch wraps around to
    the beginning of the data, and ``getpad()`` reports the wrapped
    count. ``num_parts``/``part_index`` split rows contiguously.
    """

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=None, batch_size=1, round_batch=True,
                 num_parts=1, part_index=0, data_name="data",
                 label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        if not round_batch:
            raise ValueError(
                "LibSVMIter only supports round_batch=True "
                "(reference: src/io/iter_libsvm.cc round_batch check)")
        if len(tuple(data_shape)) != 1:
            raise ValueError("data_shape must be 1-D (num features)")
        self._num_features = int(tuple(data_shape)[0])
        labels, rows = _parse_libsvm(data_libsvm,
                                     with_label=label_libsvm is None)
        if label_libsvm is not None:
            lab2, lrows = _parse_libsvm(label_libsvm, with_label=True)
            if label_shape and len(tuple(label_shape)) == 1 and \
                    tuple(label_shape)[0] > 1:
                # dense multi-value label rows come from the sparse
                # cols; a bare leading value only covers rows with no
                # sparse entries
                L = int(tuple(label_shape)[0])
                dense = _np.zeros((len(lrows), L), _np.float32)
                for r, row in enumerate(lrows):
                    if lab2[r] and not row:
                        dense[r, 0] = lab2[r][0]
                    for i, v in row:
                        dense[r, i] = v
                self._labels = dense
            else:
                # scalar labels: a bare leading value or a sparse 0:v
                # entry both denote the label
                self._labels = _np.asarray(
                    [l[0] if l else (row[0][1] if row else 0.0)
                     for l, row in zip(lab2, lrows)], _np.float32)
        else:
            self._labels = _np.asarray(
                [l[0] if l else 0.0 for l in labels], _np.float32)
        if len(self._labels) != len(rows):
            raise ValueError(
                f"label rows ({len(self._labels)}) != data rows "
                f"({len(rows)})")
        # partition (not guaranteed even, like the reference)
        n = len(rows)
        if num_parts > 1:
            # even split: every part gets floor/ceil rows, so no worker
            # comes up empty while n >= num_parts
            lo = part_index * n // num_parts
            hi = (part_index + 1) * n // num_parts
            rows = rows[lo:hi]
            self._labels = self._labels[lo:hi]
            n = len(rows)
        if n == 0:
            raise ValueError(f"no rows in {data_libsvm}")
        for row in rows:
            for i, _ in row:
                if i >= self._num_features:
                    raise ValueError(
                        f"feature index {i} >= data_shape {data_shape}")
        self._rows = rows
        self._num_rows = n
        self._ctx = current_context()
        self._data_name = data_name
        self._label_name = label_name
        self._cursor = 0
        self._pad = 0
        self._batch = None

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size, self._num_features))]

    @property
    def provide_label(self):
        shp = (self.batch_size,) + tuple(self._labels.shape[1:])
        return [DataDesc(self._label_name, shp)]

    def reset(self):
        self._cursor = 0

    def iter_next(self):
        if self._cursor >= self._num_rows:
            return False
        idx = [(self._cursor + k) % self._num_rows
               for k in range(self.batch_size)]
        self._pad = max(0, self._cursor + self.batch_size
                        - self._num_rows)
        self._cursor += self.batch_size
        values, indices, indptr = [], [], [0]
        for r in idx:
            for i, v in self._rows[r]:
                indices.append(i)
                values.append(v)
            indptr.append(len(values))
        from ..ndarray.sparse import CSRNDArray
        csr = CSRNDArray(
            _np.asarray(values, _np.float32),
            _np.asarray(indptr, _np.int64),
            _np.asarray(indices, _np.int64),
            (self.batch_size, self._num_features), ctx=self._ctx)
        self._batch = (csr, nd_array(self._labels[idx], ctx=self._ctx))
        return True

    def getdata(self):
        return [self._batch[0]]

    def getlabel(self):
        return [self._batch[1]]

    def getpad(self):
        return self._pad


def _pop_mean_std(kwargs):
    """mean_r/g/b + std_r/g/b channel kwargs -> (mean, std) tuples."""
    mean = std = None
    if any(k in kwargs for k in ("mean_r", "mean_g", "mean_b")):
        mean = (kwargs.pop("mean_r", 0.0), kwargs.pop("mean_g", 0.0),
                kwargs.pop("mean_b", 0.0))
    if any(k in kwargs for k in ("std_r", "std_g", "std_b")):
        std = (kwargs.pop("std_r", 1.0), kwargs.pop("std_g", 1.0),
               kwargs.pop("std_b", 1.0))
    return mean, std


# option names ImageRecordIterNative implements directly; anything else
# (brightness, pca_noise, rand_resize, ...) falls back to ImageIter
_NATIVE_REC_KEYS = {
    "path_imgrec", "path_imgidx", "data_shape", "batch_size", "shuffle",
    "rand_crop", "rand_mirror", "resize", "num_parts", "part_index",
    "preprocess_threads", "label_width", "seed", "layout", "data_name",
    "label_name", "last_batch_handle", "mean", "std",
    "mean_r", "mean_g", "mean_b", "std_r", "std_g", "std_b",
}


def _native_rec_kwargs(args, kwargs):
    """kwargs for ImageRecordIterNative, or None if out of its scope."""
    if args or not kwargs.get("path_imgrec"):
        return None
    if any(k not in _NATIVE_REC_KEYS for k in kwargs):
        return None
    if kwargs.get("last_batch_handle", "pad") == "roll_over":
        return None
    kw = dict(kwargs)
    mean, std = _pop_mean_std(kw)
    if mean is not None and "mean" not in kw:
        kw["mean"] = mean
    if std is not None and "std" not in kw:
        kw["std"] = std
    shape = tuple(kw.get("data_shape", ()))
    channels = shape[-1] if kw.get("layout") == "NHWC" else shape[:1]
    gray = channels in (1, (1,))
    if (kw.get("mean") is not None or kw.get("std") is not None) and gray:
        return None  # channel stats here assume 3-channel decode
    return kw


def MXDataIter(iter_name, *args, **kwargs):
    """The reference's C++ iterators by name (reference:
    python/mxnet/io/io.py:935 creates C++ iterators via
    MXDataIterCreateIter; here each name maps to the Python/native-reader
    implementation of the same pipeline, as in the JAX package):

    - ImageRecordIter / ImageRecordIter_v1 / ImageRecordUInt8Iter ->
      image.ImageRecordIterNative (the C++ decode/augment worker pool of
      mxnet_tpu_torch/native) when the options are in its scope and the
      pool builds (g++ and OpenCV's C++ libraries), else image.ImageIter
      (cv2 and the pure-Python augmenters); ``type(it)`` says which
    - CSVIter -> CSVIter
    - NDArrayIter/MNISTIter-style in-memory data -> NDArrayIter
    """
    name = iter_name if isinstance(iter_name, str) else \
        getattr(iter_name, "__name__", str(iter_name))
    if name in ("ImageRecordIter", "ImageRecordIter_v1",
                "ImageRecordUInt8Iter"):
        kwargs.pop("verbose", None)
        # Prefer the C++ decode/augment pool (the actual analogue of the
        # reference's ImageRecordIter) when the requested options fall
        # inside its support; otherwise the pure-Python ImageIter covers
        # the long tail of augmenters.
        native_kw = _native_rec_kwargs(args, kwargs)
        if native_kw is not None:
            from ..image import (ImageRecordIterNative,
                                 native_pipeline_available)
            if native_pipeline_available():
                return ImageRecordIterNative(**native_kw)
        from ..image import ImageIter
        kwargs.pop("preprocess_threads", None)
        kwargs.pop("seed", None)
        mean, std = _pop_mean_std(kwargs)
        if (mean is not None or std is not None) and \
                "mean" not in kwargs and "std" not in kwargs:
            # CreateAugmenter normalizes only when BOTH are present;
            # default the missing one so mean-only/std-only requests
            # behave the same as on the native path
            kwargs["mean"] = _np.asarray(
                mean if mean is not None else (0.0, 0.0, 0.0),
                _np.float32)
            kwargs["std"] = _np.asarray(
                std if std is not None else (1.0, 1.0, 1.0), _np.float32)
        resize = kwargs.pop("resize", 0)
        if resize and "aug_list" not in kwargs:
            # the JAX package leaves mean and std out of this list, so a
            # resizing iterator there never normalizes; here it does, as
            # the native pool and the reference's C++ iterator do
            from ..image import CreateAugmenter
            kwargs["aug_list"] = CreateAugmenter(
                data_shape=tuple(kwargs.get("data_shape")),
                resize=resize,
                rand_crop=kwargs.pop("rand_crop", False),
                rand_mirror=kwargs.pop("rand_mirror", False),
                mean=kwargs.pop("mean", None), std=kwargs.pop("std", None))
        return ImageIter(*args, **kwargs)
    if name == "CSVIter":
        return CSVIter(*args, **kwargs)
    if name == "LibSVMIter":
        return LibSVMIter(*args, **kwargs)
    if name in ("NDArrayIter", "MNISTIter"):
        return NDArrayIter(*args, **kwargs)
    raise MXNetError(
        f"MXDataIter: no equivalent in the port for {name!r}; use "
        "NDArrayIter, CSVIter, image.ImageIter, or "
        "gluon.data.DataLoader")

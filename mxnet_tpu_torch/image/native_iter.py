"""ImageRecordIterNative: the C++ decode/augment pipeline as a DataIter
(mirrors ``mxnet_tpu/image/native_iter.py``).

The native analogue of the reference's ImageRecordIter (reference:
src/io/iter_image_recordio_2.cc:887 — worker threads decode JPEG and
augment into pre-staged batch buffers; Python only sees full batches).
Policy (shuffle order, sharding, padding) lives here; the C++ side
(``native/src/imagepipe_native.cpp``) does the bandwidth-heavy work. A
batch lands on the iterator's context (``ctx=``, else the current
context at construction: the card unless a ``with mx.cpu():`` block says
otherwise), copied from a host buffer of its own.

Unlike the reference, batches are bit-deterministic for a fixed seed
regardless of preprocess_threads, because per-sample RNG is keyed on
(epoch_seed, sample_index) rather than on worker-thread state.
"""
from __future__ import annotations

import ctypes
import os

import numpy as _np

from ..base import MXNetError
from ..io.io import DataBatch, DataDesc, DataIter
from ..ndarray import array as nd_array

__all__ = ["ImageRecordIterNative", "native_pipeline_available"]


def _load_idx(path_imgidx):
    offsets = []
    with open(path_imgidx) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) >= 2:
                offsets.append(int(parts[1]))
    return _np.asarray(offsets, dtype=_np.int64)


def native_pipeline_available():
    from ..native import imagepipe_lib
    return imagepipe_lib() is not None


class ImageRecordIterNative(DataIter):
    """Threaded C++ JPEG decode + augment over a .rec/.idx pair."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, shuffle=False, rand_crop=False,
                 rand_mirror=False, resize=0, mean=None, std=None,
                 num_parts=1, part_index=0, preprocess_threads=0,
                 label_width=1, seed=0, layout="NCHW",
                 data_name="data", label_name="softmax_label",
                 last_batch_handle="pad", strict=None):
        super().__init__(batch_size)
        # strict=True: a record that fails to decode (or has the wrong
        # label_width) raises, matching the reference's CHECK semantics
        # (src/io/iter_image_recordio_2.cc label-width CHECK / decode
        # crash). Default (strict=False) warns loudly instead of the old
        # silent zero-fill. Env override: MXNET_TPU_IMAGEPIPE_STRICT=1.
        if strict is None:
            strict = os.environ.get("MXNET_TPU_IMAGEPIPE_STRICT") == "1"
        self._strict = bool(strict)
        self._warned_errors = 0
        from ..native import imagepipe_lib
        lib = imagepipe_lib()
        if lib is None:
            raise MXNetError(
                "native image pipeline unavailable (toolchain or OpenCV "
                "missing, or MXNET_TPU_NATIVE=0); use image.ImageIter")
        self._lib = lib
        data_shape = tuple(int(x) for x in data_shape)
        if layout == "NCHW":
            c, h, w = data_shape
        else:
            h, w, c = data_shape
        self._hwcn = (h, w, c)
        self._nhwc = layout == "NHWC"
        self.data_shape = data_shape
        self.label_width = int(label_width)
        self._seed = int(seed)
        self._epoch = -1
        self._shuffle = shuffle
        self._pad = 0
        self._exhausted = False
        if last_batch_handle not in ("pad", "discard"):
            raise MXNetError(
                f"last_batch_handle={last_batch_handle!r} unsupported "
                "here (pad/discard); use image.ImageIter for roll_over")
        self._discard_last = last_batch_handle == "discard"

        if path_imgidx is None:
            path_imgidx = os.path.splitext(path_imgrec)[0] + ".idx"
        offsets = _load_idx(path_imgidx)
        if num_parts > 1:
            offsets = offsets[part_index::num_parts]
        if offsets.size == 0:
            raise MXNetError(f"no records indexed by {path_imgidx!r}")
        self._offsets = offsets

        mean_a = std_a = None
        if mean is not None or std is not None:
            mean_a = _np.zeros(c, _np.float32) if mean is None else \
                _np.asarray(mean, _np.float32).reshape(c)
            std_a = _np.ones(c, _np.float32) if std is None else \
                _np.asarray(std, _np.float32).reshape(c)
        self._mean_keepalive = (mean_a, std_a)

        nthreads = preprocess_threads or min(os.cpu_count() or 4, 16)
        f32p = ctypes.POINTER(ctypes.c_float)
        self._h = lib.ip_create(
            path_imgrec.encode(), batch_size, h, w, c, nthreads,
            1 if self._nhwc else 0, int(resize),
            1 if rand_crop else 0, 1 if rand_mirror else 0,
            mean_a.ctypes.data_as(f32p) if mean_a is not None else None,
            std_a.ctypes.data_as(f32p) if std_a is not None else None,
            self.label_width)
        if not self._h:
            raise MXNetError(f"cannot open {path_imgrec!r}")

        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + data_shape,
                                      layout=layout)]
        lshape = (batch_size, self.label_width) if self.label_width > 1 \
            else (batch_size,)
        self.provide_label = [DataDesc(label_name, lshape)]
        self.reset()

    def reset(self):
        self._epoch += 1
        order = self._offsets
        if self._shuffle:
            rng = _np.random.RandomState(self._seed + self._epoch)
            order = order.copy()
            rng.shuffle(order)
        n = order.size
        if self._discard_last:
            self._pad = 0
            order = order[:n - n % self.batch_size]
        else:
            self._pad = (-n) % self.batch_size
            if self._pad:
                order = _np.concatenate([order, order[:self._pad]])
        order = _np.ascontiguousarray(order, _np.int64)
        self._nbatches = order.size // self.batch_size
        self._cursor = 0
        self._exhausted = False
        self._lib.ip_start_epoch(
            self._h, order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            order.size, ctypes.c_uint32((self._seed + self._epoch)
                                        & 0xFFFFFFFF))

    def iter_next(self):
        return self._cursor < self._nbatches

    def next(self):
        if self._exhausted or not self.iter_next():
            self._exhausted = True
            raise StopIteration
        shape = (self.batch_size,) + tuple(self.data_shape)
        data = _np.empty(shape, _np.float32)
        label = _np.empty((self.batch_size, self.label_width), _np.float32)
        f32p = ctypes.POINTER(ctypes.c_float)
        count = self._lib.ip_next_batch(
            self._h, data.ctypes.data_as(f32p),
            label.ctypes.data_as(f32p))
        if count <= 0:
            self._exhausted = True
            raise StopIteration
        self._check_errors()
        self._cursor += 1
        pad = self._pad if self._cursor == self._nbatches else 0
        if self.label_width == 1:
            label = label[:, 0]
        return DataBatch(data=[nd_array(data)],
                         label=[nd_array(label)],
                         pad=pad, index=None,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def getpad(self):
        return self._pad if self._cursor == self._nbatches else 0

    @property
    def error_count(self):
        """Records that failed to decode (zero-filled), cumulative."""
        return int(self._lib.ip_error_count(self._h))

    @property
    def last_error(self):
        """Message from the most recent native decode/parse failure."""
        msg = self._lib.ip_last_error(self._h)
        return msg.decode(errors="replace") if msg else ""

    def _check_errors(self):
        """Surface native decode/parse failures instead of training on
        zero-filled images (reference hard-fails here; advisor r4)."""
        n = self.error_count
        if n <= self._warned_errors:
            return
        detail = (f"{n} record(s) failed to decode/parse and were "
                  f"zero-filled; last error: {self.last_error!r}")
        if self._strict:
            raise MXNetError(
                detail + " (strict mode; pass strict=False or unset "
                "MXNET_TPU_IMAGEPIPE_STRICT to tolerate)")
        import logging
        logging.getLogger("mxnet_tpu_torch").warning(
            "ImageRecordIterNative: %s — training data is corrupt or "
            "label_width mismatches; set strict=True to raise", detail)
        self._warned_errors = n

    def close(self):
        if getattr(self, "_h", None):
            self._lib.ip_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

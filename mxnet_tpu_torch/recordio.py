"""RecordIO: the record-structured binary container (mirrors
``mxnet_tpu/recordio.py``).

Reference: python/mxnet/recordio.py:36 (MXRecordIO/MXIndexedRecordIO over
the dmlc-core C++ reader) + dmlc-core recordio framing. The binary format
is the reference's (kMagic 0xced7230a, cflag<<29|len header, 4-byte
alignment, IRHeader struct), so .rec/.idx files interchange with the
reference's im2rec output and with the JAX package's, byte for byte.
Reads go through the C++ reader of :mod:`mxnet_tpu_torch.native` where it
builds, else through the pure-Python parser; cv2 is imported only by
``pack_img``/``unpack_img``.
"""
from __future__ import annotations

import ctypes
import os
import struct
from collections import namedtuple

import numpy as _np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_kMagic = 0xced7230a
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential .rec reader/writer (reference: recordio.py:36)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self.is_open = False
        self.open()

    def open(self):
        self._native = None
        if self.flag == "w":
            self.fhandle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fhandle = open(self.uri, "rb")
            self.writable = False
            # fast path: the C++ reader (mxnet_tpu_torch/native) parses and
            # assembles records off the GIL; transparently falls back to
            # the pure-Python parser when no toolchain is available
            try:
                from .native import NativeRecordReader
                self._native = NativeRecordReader(self.uri)
            except Exception:
                self._native = None
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.pid = os.getpid()
        self.is_open = True

    def __del__(self):
        self.close()

    def __getstate__(self):
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d.pop("fhandle", None)
        d.pop("_native", None)
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        is_open = d.get("is_open", False)
        self.is_open = False
        if is_open:
            self.open()

    def _check_pid(self, allow_reset=False):
        # forked workers must reopen their own handle (reference:
        # recordio.py _check_pid — DataLoader worker semantics)
        if self.pid != os.getpid():
            if allow_reset:
                self.reset()
            else:
                raise RuntimeError("Forbidden operation in a forked "
                                   "process")

    def close(self):
        if not self.is_open:
            return
        if getattr(self, "_native", None) is not None:
            self._native.close()
            self._native = None
        self.fhandle.close()
        self.is_open = False
        self.pid = None

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        """Append one record (reference: recordio.py:180; framing
        dmlc-core include/dmlc/recordio.h). Payloads containing the magic
        word are split into multipart records (cflag 1=begin, 2=middle,
        3=end) exactly like the dmlc writer, so files interchange."""
        assert self.writable
        self._check_pid(allow_reset=False)
        magic_bytes = struct.pack("<I", _kMagic)
        # split at aligned occurrences of the magic word (dmlc scans in
        # 4-byte steps)
        parts = []
        start = 0
        for off in range(0, len(buf) - 3, 4):
            if buf[off:off + 4] == magic_bytes:
                parts.append(buf[start:off])
                start = off + 4
        parts.append(buf[start:])
        for i, part in enumerate(parts):
            if len(parts) == 1:
                cflag = 0
            elif i == 0:
                cflag = 1
            elif i == len(parts) - 1:
                cflag = 3
            else:
                cflag = 2
            self.fhandle.write(magic_bytes)
            self.fhandle.write(struct.pack(
                "<I", (cflag << 29) | len(part)))
            self.fhandle.write(part)
            pad = (4 - (len(part) % 4)) % 4
            if pad:
                self.fhandle.write(b"\x00" * pad)

    def _read_chunk(self):
        header = self.fhandle.read(8)
        if len(header) < 8:
            return None, None
        magic, lrec = struct.unpack("<II", header)
        assert magic == _kMagic, "invalid record magic"
        cflag = lrec >> 29
        length = lrec & ((1 << 29) - 1)
        buf = self.fhandle.read(length)
        pad = (4 - (length % 4)) % 4
        if pad:
            self.fhandle.read(pad)
        return cflag, buf

    def read(self):
        """Read next record or None (reference: recordio.py:210).
        Multipart records are rejoined with the magic word re-inserted at
        the split points (dmlc-core ReadRecord semantics)."""
        assert not self.writable
        self._check_pid(allow_reset=True)
        if self._native is not None:
            return self._native.read()
        cflag, buf = self._read_chunk()
        if buf is None:
            return None
        if cflag == 0:
            return buf
        assert cflag == 1, f"unexpected continuation flag {cflag}"
        magic_bytes = struct.pack("<I", _kMagic)
        parts = [buf]
        while True:
            cflag, buf = self._read_chunk()
            assert buf is not None, "truncated multipart record"
            parts.append(buf)
            if cflag == 3:
                break
            assert cflag == 2, f"unexpected continuation flag {cflag}"
        return magic_bytes.join(parts)

    def tell(self):
        if getattr(self, "_native", None) is not None and not self.writable:
            return self._native.tell()
        return self.fhandle.tell()


class MXIndexedRecordIO(MXRecordIO):
    """.rec + .idx random access (reference: recordio.py:247)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        if self.writable:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def seek(self, idx):
        assert not self.writable
        self._check_pid(allow_reset=True)
        if self._native is not None:
            self._native.seek(self.idx[idx])
        else:
            self.fhandle.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.keys.append(key)
        self.idx[key] = pos


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
"""Record header (reference: recordio.py:344 IRHeader)."""


def pack(header, s):
    """Pack a header + byte payload (reference: recordio.py:355)."""
    header = IRHeader(*header)
    label = header.label
    if isinstance(label, (_np.ndarray, list, tuple)):
        label = _np.asarray(label, dtype=_np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, header.flag, header.label, header.id,
                       header.id2) + s


def unpack(s):
    """Unpack to (header, payload) (reference: recordio.py:389)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = _np.frombuffer(s[:header.flag * 4], dtype=_np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=1):
    """Unpack a packed image record (reference: recordio.py:417)."""
    import cv2
    header, s = unpack(s)
    img = cv2.imdecode(_np.frombuffer(s, dtype=_np.uint8), iscolor)
    if img is not None and img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return header, img


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image array (reference: recordio.py:453)."""
    import cv2
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    encode_params = None
    if img_fmt in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    ret, buf = cv2.imencode(img_fmt, img, encode_params)
    assert ret, "failed to encode image"
    return pack(header, buf.tobytes())

"""PyTorch port, records (``mxnet_tpu_torch/recordio.py``,
``mxnet_tpu_torch/native``) against the JAX package:

- the JAX suite's ``tests/test_recordio_image.py`` (10 cases) and
  ``tests/test_native_recordio.py`` (4) run through the port by text
  substitution;
- ``.rec``/``.idx`` files the two packages write from the same records
  (JPEG and PNG images, multi-float labels, payloads holding the magic
  word) are byte-equal, and each package reads the other's;
- the native libraries build where g++ and OpenCV are (a failed build
  fails here, it does not skip), and processes that build them at once
  each load a whole library, neither failing nor skipping.
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
import torch  # noqa: E402

from mxnet_tpu import recordio as jrec  # noqa: E402
from mxnet_tpu_torch import native, recordio as trec  # noqa: E402

torch.set_num_threads(2)


def _symbol_tests():
    spec = importlib.util.spec_from_file_location(
        "_torch_symbol_cases_rec", os.path.join(HERE, "test_torch_symbol.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SYM = _symbol_tests()
CASES = {f: SYM.load_reference_tests(f)
         for f in ("test_recordio_image", "test_native_recordio")}


def test_the_native_libraries_build_here():
    assert native.recordio_lib() is not None, native.last_build_error
    assert native.imagepipe_lib() is not None, native.last_build_error


@pytest.mark.parametrize("file,name", [
    (f, n) for f, cases in CASES.items() for n in cases])
def test_reference_record_case_through_the_port(file, name, tmp_path):
    SYM.run_reference_test(CASES[file][name], tmp_path)


def _records(rs):
    import cv2
    out = []
    for i in range(12):
        img = rs.randint(0, 256, (20 + i, 24, 3)).astype(np.uint8)
        fmt = ".jpg" if i % 2 else ".png"
        label = rs.randn(3).astype(np.float32) if i % 3 == 0 else \
            float(i % 5)
        out.append(("img", (0, label, i, 0), img, fmt))
    magic = (0xced7230a).to_bytes(4, "little")
    out.append(("raw", (0, 1.0, 99, 0), b"ab" + magic + b"cd" * 9, None))
    out.append(("raw", (0, 2.0, 100, 7), magic * 3, None))
    ok, buf = cv2.imencode(".png", rs.randint(0, 256, (8, 8, 3))
                           .astype(np.uint8))
    out.append(("raw", (0, 3.0, 101, 0), buf.tobytes(), None))
    return out


def _write(rec_mod, prefix, records):
    w = rec_mod.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for k, (kind, header, body, fmt) in enumerate(records):
        h = rec_mod.IRHeader(*header)
        if kind == "img":
            w.write_idx(k, rec_mod.pack_img(h, body, quality=90,
                                            img_fmt=fmt))
        else:
            w.write_idx(k, rec_mod.pack(h, body))
    w.close()


def test_rec_and_idx_files_are_byte_equal_across_packages(tmp_path):
    records = _records(np.random.RandomState(0))
    _write(trec, str(tmp_path / "t"), records)
    _write(jrec, str(tmp_path / "j"), records)
    for ext in (".rec", ".idx"):
        assert (tmp_path / ("t" + ext)).read_bytes() == \
            (tmp_path / ("j" + ext)).read_bytes()
    # each reads the other's file: the same headers and images
    tr = trec.MXIndexedRecordIO(str(tmp_path / "j.idx"),
                                str(tmp_path / "j.rec"), "r")
    jr = jrec.MXIndexedRecordIO(str(tmp_path / "t.idx"),
                                str(tmp_path / "t.rec"), "r")
    assert tr._native is not None
    for k, (kind, *_rest) in enumerate(records):
        a, b = tr.read_idx(k), jr.read_idx(k)
        assert a == b
        if kind == "img":
            (ha, ia), (hb, ib) = trec.unpack_img(a), jrec.unpack_img(b)
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(ha.label, hb.label)
            assert ha.id == hb.id
    tr.close()
    jr.close()


_RACE = """
import os, sys, time
sys.path.insert(0, {root!r})
from mxnet_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
start = float(sys.argv[2])
while time.time() < start:
    time.sleep(0.001)
libs = native.recordio_lib(), native.imagepipe_lib()
assert all(lib is not None for lib in libs), native.last_build_error
h = libs[0].rio_open_reader(sys.argv[3].encode())
assert h
libs[0].rio_close(h)
print("built")
"""


def test_processes_building_at_once_each_load_a_whole_library(tmp_path):
    build = tmp_path / "build"
    rec = str(tmp_path / "x.rec")
    w = trec.MXRecordIO(rec, "w")
    w.write(b"x")
    w.close()
    code = _RACE.format(root=ROOT)
    start = f"{__import__('time').time() + 3.0:.3f}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(build), start, rec],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "built", err
    names = sorted(os.listdir(build))
    assert len(names) == 2 and all(n.endswith(".so") for n in names), names
    assert names == sorted(os.path.basename(native.library_path(n)[1])
                           for n in ("imagepipe_native", "recordio_native"))


def test_native_switch_forces_the_python_reader(tmp_path, monkeypatch):
    """``MXNET_TPU_NATIVE=0`` (the reference's switch) reads through the
    pure-Python parser, byte for byte the native reader's."""
    records = _records(np.random.RandomState(1))
    _write(trec, str(tmp_path / "s"), records)
    got = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("MXNET_TPU_NATIVE", flag)
        r = trec.MXRecordIO(str(tmp_path / "s.rec"), "r")
        assert (r._native is None) == (flag == "0")
        got[flag] = list(iter(r.read, None))
        r.close()
    assert got["0"] == got["1"] and len(got["0"]) == len(records)
    assert native.recordio_lib() is None

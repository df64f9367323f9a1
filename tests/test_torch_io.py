"""PyTorch port, ``mx.io`` (``mxnet_tpu_torch/io/io.py``) against the JAX
package's iterators, batch by batch on the same data (exact: the
iterators only gather rows):

- ``NDArrayIter`` with ``last_batch_handle`` ``pad``, ``discard`` and
  ``roll_over``, shuffled (both draw the order from numpy's global
  generator), over one array, a list and a dict of arrays, labels or
  none: each batch's data, label, pad and the ``provide_*`` descriptors;
- ``ResizeIter`` (a shorter and a longer epoch), ``PrefetchingIter``,
  ``CSVIter`` and ``LibSVMIter`` over files the test writes (the CSR
  batches densified), ``DataDesc`` and ``DataBatch``;
- ``MXDataIter("ImageRecordIter")`` over records: the JAX package's
  iterator and batches;
- batches are NDArrays on the iterator's context: the CPU inside
  ``with mx.cpu():``.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402

torch.set_num_threads(2)

RS = np.random.RandomState(0)
X = RS.randn(10, 3).astype(np.float32)
X2 = RS.randn(10, 2, 2).astype(np.float32)
Y = np.arange(10, dtype=np.float32)


def _batches(it, epochs=2):
    out = []
    for _ in range(epochs):
        for b in it:
            out.append(dict(
                data=[d.asnumpy() for d in b.data],
                label=[l.asnumpy() for l in (b.label or [])],
                pad=b.pad))
        it.reset()
    return out


def _descs(it):
    return ([(d.name, tuple(d.shape)) for d in it.provide_data],
            [(d.name, tuple(d.shape)) for d in it.provide_label])


def _same(jit, tit, epochs=2):
    assert _descs(tit) == _descs(jit)
    want = _batches(jit, epochs)
    with tmx.cpu():
        got = _batches(tit, epochs)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["pad"] == w["pad"]
        for a, b in zip(g["data"] + g["label"], w["data"] + w["label"]):
            np.testing.assert_array_equal(a, b)


def _pair(make, seed=None):
    """One iterator of each package from ``make(mx)``; with ``seed`` each
    starts numpy's global generator there (shuffled orders)."""
    if seed is not None:
        np.random.seed(seed)
    j = make(jmx)
    if seed is not None:
        np.random.seed(seed)
    with tmx.cpu():
        t = make(tmx)
    return j, t


ITERS = {
    "pad": lambda mx: mx.io.NDArrayIter(X, Y, batch_size=3,
                                        last_batch_handle="pad"),
    "discard": lambda mx: mx.io.NDArrayIter(X, Y, batch_size=3,
                                            last_batch_handle="discard"),
    "roll_over": lambda mx: mx.io.NDArrayIter(
        X, Y, batch_size=4, last_batch_handle="roll_over"),
    "shuffle": lambda mx: mx.io.NDArrayIter(X, Y, batch_size=4,
                                            shuffle=True),
    "list": lambda mx: mx.io.NDArrayIter([X, X2], Y, batch_size=5),
    "dict": lambda mx: mx.io.NDArrayIter({"a": X, "b": X2},
                                         {"lab": Y}, batch_size=5),
    "no_label": lambda mx: mx.io.NDArrayIter(X, batch_size=4,
                                             data_name="feat"),
    "nd_input": lambda mx: mx.io.NDArrayIter(mx.nd.array(X),
                                             mx.nd.array(Y), batch_size=6),
}


@pytest.mark.parametrize("name", sorted(ITERS))
def test_ndarray_iter_matches_the_reference(name):
    j, t = _pair(ITERS[name], seed=3)
    if name == "shuffle":
        np.random.seed(4)
        want = _batches(j)
        np.random.seed(4)
        with tmx.cpu():
            got = _batches(t)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["data"][0], w["data"][0])
            np.testing.assert_array_equal(g["label"][0], w["label"][0])
        return
    _same(j, t)


@pytest.mark.parametrize("size", [2, 7])
def test_resize_iter_matches_the_reference(size):
    j, t = _pair(lambda mx: mx.io.ResizeIter(
        mx.io.NDArrayIter(X, Y, batch_size=3), size))
    assert t.batch_size == j.batch_size == 3
    _same(j, t)


def test_prefetching_iter_matches_the_reference():
    j, t = _pair(lambda mx: mx.io.PrefetchingIter(
        mx.io.NDArrayIter(X, Y, batch_size=4), device_prefetch=False))
    _same(j, t)


def test_csv_iter_matches_the_reference(tmp_path):
    np.savetxt(tmp_path / "d.csv", X2.reshape(10, 4), delimiter=",")
    np.savetxt(tmp_path / "l.csv", Y, delimiter=",")
    j, t = _pair(lambda mx: mx.io.CSVIter(
        data_csv=str(tmp_path / "d.csv"), data_shape=(2, 2),
        label_csv=str(tmp_path / "l.csv"), batch_size=4))
    _same(j, t)


def _write_libsvm(path, rows, seed):
    rs = np.random.RandomState(seed)
    with open(path, "w") as f:
        for r in range(rows):
            cols = np.sort(rs.choice(20, size=rs.randint(1, 6),
                                     replace=False))
            f.write(f"{r % 2} " + " ".join(
                f"{c}:{rs.randn():.4f}" for c in cols) + "\n")


@pytest.mark.parametrize("parts", [1, 2])
def test_libsvm_iter_matches_the_reference(parts, tmp_path):
    path = str(tmp_path / "x.libsvm")
    _write_libsvm(path, 11, seed=parts)
    j, t = _pair(lambda mx: mx.io.LibSVMIter(
        data_libsvm=path, data_shape=(20,), batch_size=4,
        num_parts=parts, part_index=parts - 1))
    assert _descs(t) == _descs(j)
    want, got = [], []
    for it, out in ((j, want), (t, got)):
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                        b.pad, b.data[0].stype))
        it.reset()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2:] == w[2:] == (g[2], "csr")


def test_descriptors_batches_and_context():
    d = tmx.io.DataDesc("data", (2, 3), layout="NTC")
    j = jmx.io.DataDesc("data", (2, 3), layout="NTC")
    assert repr(d) == repr(j)
    assert tmx.io.DataDesc.get_batch_axis("NTC") == \
        jmx.io.DataDesc.get_batch_axis("NTC") == 0
    assert tmx.io.DataDesc.get_batch_axis("TNC") == 1
    with tmx.cpu():
        it = tmx.io.NDArrayIter(X, Y, batch_size=4)
        b = next(iter(it))
    assert b.data[0].context == tmx.cpu() and b.label[0].context == tmx.cpu()
    jb = next(iter(jmx.io.NDArrayIter(X, Y, batch_size=4)))
    assert str(b) == str(jb)
    assert isinstance(b.data[0], tmx.nd.NDArray)


def test_mx_data_iter_raises_naming_the_roadmap_item(tmp_path):
    """Ported (ROADMAP §1 item 14c): ``MXDataIter("ImageRecordIter")``
    over records both packages read gives the JAX package's iterator
    type and batches, bit for bit; a name neither maps still raises."""
    import cv2
    rs = np.random.RandomState(3)
    rec, idx = str(tmp_path / "x.rec"), str(tmp_path / "x.idx")
    w = tmx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(6):
        ok, buf = cv2.imencode(".png", rs.randint(0, 256, (10, 10, 3))
                               .astype(np.uint8))
        w.write_idx(i, tmx.recordio.pack(
            tmx.recordio.IRHeader(0, float(i), i, 0), buf.tobytes()))
    w.close()
    kw = dict(path_imgrec=rec, data_shape=(3, 8, 8), batch_size=4,
              rand_crop=True, rand_mirror=True, seed=2)
    with tmx.cpu():
        t = tmx.io.MXDataIter("ImageRecordIter", **kw)
        tb = list(t)
    j = jmx.io.MXDataIter("ImageRecordIter", **kw)
    jb = list(j)
    assert type(t).__name__ == type(j).__name__ == "ImageRecordIterNative"
    assert len(tb) == len(jb) == 2 and [b.pad for b in tb] == [0, 2]
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.data[0].asnumpy(),
                                      b.data[0].asnumpy())
        np.testing.assert_array_equal(a.label[0].asnumpy(),
                                      b.label[0].asnumpy())
    with pytest.raises(tmx.MXNetError, match="no equivalent"):
        tmx.io.MXDataIter("MNISTIterator")

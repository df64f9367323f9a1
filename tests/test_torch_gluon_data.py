"""PyTorch port, ``gluon.data`` and ``gluon.utils`` against the JAX
package's: the synthetic MNIST/FashionMNIST/CIFAR10/CIFAR100 and their
file readers, the ``Dataset`` methods, every sampler (the shuffles from
one numpy seed) and the default batchify, bit for bit; the
``DataLoader`` with 0 and 2 worker processes and with a thread pool (the
counterpart of ``tests/test_dataloader_workers.py``), a worker's error
surfacing in the consumer; ``DevicePrefetchIter`` and ``stage_batch``
on CPU tensors (the counterparts of ``tests/test_device_prefetch.py``);
the vision transforms; ``split_data``, ``split_and_load`` and
``clip_global_norm``.

Tolerance: bit for bit, but for ``Resize``'s interpolation
(``TRANSFORM_TOL = 1e-5`` of 255: float64 weights here, XLA's f32
contraction there) and ``clip_global_norm`` (``CLIP_TOL = 1e-6``
relative: a sum of squares in another order).
"""
import struct
import time
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.data.vision import transforms as jtf

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data.vision import transforms as ttf
from mxnet_tpu_torch.gluon.utils import (clip_global_norm, split_and_load,
                                         split_data)

torch.set_num_threads(2)

TRANSFORM_TOL = 1e-5
CLIP_TOL = 1e-6

jdata = jgluon.data


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return np.asarray(x)


@pytest.mark.parametrize("cls,kw", [
    ("MNIST", dict(train=True)), ("MNIST", dict(train=False)),
    ("FashionMNIST", {}), ("CIFAR10", dict(train=True)),
    ("CIFAR100", dict(train=False, fine_label=True))])
def test_synthetic_datasets_are_the_references(cls, kw, tmp_path):
    j = getattr(jdata.vision, cls)(root=str(tmp_path), **kw)
    t = getattr(tdata.vision, cls)(root=str(tmp_path / "t"), **kw)
    np.testing.assert_array_equal(t._data, j._data)
    np.testing.assert_array_equal(t._label, j._label)
    assert len(t) == len(j)
    (tx, ty), (jx, jy) = t[17], j[17]
    assert isinstance(tx, tmx.NDArray) and tx.context == tmx.cpu()
    np.testing.assert_array_equal(tx.asnumpy(), jx.asnumpy())
    assert ty == jy
    assert not (tmp_path / "t").exists()        # the port writes nothing


def test_file_readers_are_the_references(tmp_path):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, 5).astype(np.uint8)
    with open(tmp_path / "t10k-images-idx3-ubyte", "wb") as f:
        f.write(struct.pack(">IIII", 0x803, 5, 28, 28) + imgs.tobytes())
    with open(tmp_path / "t10k-labels-idx1-ubyte", "wb") as f:
        f.write(struct.pack(">II", 0x801, 5) + labels.tobytes())
    recs = np.concatenate([labels[:, None], rs.randint(
        0, 256, (5, 3 * 32 * 32))], axis=1).astype(np.uint8)
    (tmp_path / "test_batch.bin").write_bytes(recs.tobytes())
    for cls in ("MNIST", "CIFAR10"):
        j = getattr(jdata.vision, cls)(root=str(tmp_path), train=False)
        t = getattr(tdata.vision, cls)(root=str(tmp_path), train=False)
        assert len(t) == 5
        np.testing.assert_array_equal(t._data, j._data)
        np.testing.assert_array_equal(t._label, j._label)
    # the record datasets (ROADMAP §1 item 14c, ported): the JAX
    # package's items on a file both read
    import cv2
    rec = str(tmp_path / "x.rec")
    w = tmx.recordio.MXIndexedRecordIO(str(tmp_path / "x.idx"), rec, "w")
    for i in range(3):
        w.write_idx(i, tmx.recordio.pack_img(
            tmx.recordio.IRHeader(0, float(i + 1), i, 0),
            np.stack([imgs[i]] * 3, axis=-1), img_fmt=".png"))
    w.close()
    for cls in (lambda m: m.vision.ImageRecordDataset(rec),
                lambda m: m.RecordFileDataset(rec)):
        t, j = cls(tdata), cls(jdata)
        assert len(t) == len(j) == 3
        for i in range(3):
            a, b = t[i], j[i]
            if isinstance(a, bytes):
                assert a == b
                continue
            np.testing.assert_array_equal(a[0].asnumpy(), b[0].asnumpy())
            assert a[0].context == tmx.cpu() and a[1] == b[1] == i + 1
    (tmp_path / "f" / "a").mkdir(parents=True)
    (tmp_path / "f" / "b").mkdir()
    np.save(tmp_path / "f" / "b" / "x.npy", imgs[0])
    cv2.imwrite(str(tmp_path / "f" / "a" / "y.png"), imgs[1])
    folder = tdata.vision.ImageFolderDataset(str(tmp_path / "f"))
    jfolder = jdata.vision.ImageFolderDataset(str(tmp_path / "f"))
    assert folder.synsets == ["a", "b"] and len(folder) == 2
    img, label = folder[1]
    np.testing.assert_array_equal(img.asnumpy(), imgs[0])
    assert label == 1
    img, label = folder[0]
    assert img.context == tmx.cpu() and label == 0
    np.testing.assert_array_equal(img.asnumpy(), jfolder[0][0].asnumpy())
    np.testing.assert_array_equal(img.asnumpy()[..., 0], imgs[1])


def _pair_datasets():
    rs = np.random.RandomState(1)
    x = rs.randn(11, 3).astype(np.float32)
    y = np.arange(11).astype(np.float32)
    return (jdata.ArrayDataset(x, jmx.nd.array(y)),
            tdata.ArrayDataset(x, nd.array(y, ctx="cpu")))


def _double(a, *rest):
    return (a * 2,) + rest if rest else a * 2


@pytest.mark.parametrize("method", [
    "filter", "shard", "take", "transform", "transform_eager",
    "transform_first"])
def test_dataset_methods_match_jax(method):
    j, t = _pair_datasets()
    fns = {
        "filter": lambda d: d.filter(lambda s: float(s[1]) % 3 == 0),
        "shard": lambda d: d.shard(3, 1),
        "take": lambda d: d.take(4),
        "transform": lambda d: d.transform(_double),
        "transform_eager": lambda d: d.transform(_double, lazy=False),
        "transform_first": lambda d: d.transform_first(lambda a: a + 1),
    }
    jd, td = fns[method](j), fns[method](t)
    assert len(td) == len(jd)
    for i in range(len(jd)):
        for a, b in zip(_np(list(td[i])), _np(list(jd[i]))):
            np.testing.assert_array_equal(a, b)


def _samplers(pkg, ds):
    s = pkg.data
    return {
        "sequential": s.SequentialSampler(7, start=2),
        "random": s.RandomSampler(9),
        "filter": s.FilterSampler(lambda v: v % 2 == 1, list(range(9))),
        "interval": s.IntervalSampler(10, 3),
        "interval_no_rollover": s.IntervalSampler(10, 3, rollover=False),
        "batch_keep": s.BatchSampler(s.SequentialSampler(10), 3, "keep"),
        "batch_discard": s.BatchSampler(s.SequentialSampler(10), 3,
                                        "discard"),
        "batch_rollover": s.BatchSampler(s.RandomSampler(10), 4,
                                         "rollover"),
    }


@pytest.mark.parametrize("name", [
    "sequential", "random", "filter", "interval", "interval_no_rollover",
    "batch_keep", "batch_discard", "batch_rollover"])
def test_samplers_match_jax(name):
    j, t = _samplers(jgluon, None)[name], _samplers(gluon, None)[name]
    for _ in range(3):               # rollover carries across passes
        np.random.seed(7)
        want, wlen = list(j), len(j)
        np.random.seed(7)
        got, glen = list(t), len(t)
        assert got == want and glen == wlen


def test_default_batchify_matches_jax():
    rs = np.random.RandomState(2)
    samples = [(rs.randn(2, 3).astype(np.float32), i, 0.5 * i)
               for i in range(4)]
    want = jdata.dataloader.default_batchify_fn(samples)
    got = tdata.dataloader.default_batchify_fn(samples)
    for a, b in zip(got, want):
        assert a.context == tmx.cpu()
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    nds = [nd.array(s[0], ctx="cpu") for s in samples]
    np.testing.assert_array_equal(
        tdata.dataloader.default_batchify_fn(nds).asnumpy(),
        jdata.dataloader.default_batchify_fn(
            [jmx.nd.array(s[0]) for s in samples]).asnumpy())


def _loader_batches(loader):
    out = [tuple(_np(b)) for b in loader]
    if hasattr(loader, "close"):
        loader.close()
    return out


def _arrays(n=37):
    rs = np.random.RandomState(3)
    return (rs.randn(n, 4).astype(np.float32),
            rs.randint(0, 5, n).astype(np.float32))


@pytest.mark.parametrize("kw", [
    dict(), dict(num_workers=2), dict(num_workers=2, thread_pool=True),
    dict(shuffle=True, last_batch="discard"),
    dict(num_workers=2, shuffle=True, last_batch="rollover")],
    ids=["serial", "workers", "thread_pool", "shuffle", "workers_shuffle"])
def test_dataloader_matches_jax(kw):
    """The reference's serial loader against the port's with workers:
    the order is the sampler's, drawn in the main process."""
    x, y = _arrays()
    serial = {k: v for k, v in kw.items()
              if k not in ("num_workers", "thread_pool")}
    np.random.seed(11)
    want = _loader_batches(jdata.DataLoader(jdata.ArrayDataset(x, y),
                                            batch_size=8, **serial))
    np.random.seed(11)
    got = _loader_batches(tdata.DataLoader(tdata.ArrayDataset(x, y),
                                           batch_size=8, **kw))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def test_worker_error_surfaces_in_the_consumer():
    x, _ = _arrays(8)
    ds = tdata.ArrayDataset(x).transform(int)  # int(array of 4) raises
    loader = tdata.DataLoader(ds, batch_size=4, num_workers=2, timeout=60)
    with pytest.raises(TypeError):
        list(loader)
    loader.close()


def test_forkserver_preloads_the_data_module():
    """Workers fork from a server that has imported the port's data
    module (and torch) once, so a pool starts without an import a
    worker."""
    import multiprocessing
    from multiprocessing import forkserver
    if "forkserver" not in multiprocessing.get_all_start_methods():
        pytest.skip("no forkserver on this platform")
    x, _ = _arrays(8)
    loader = tdata.DataLoader(tdata.ArrayDataset(x), batch_size=4,
                              num_workers=2)
    np.testing.assert_array_equal(
        np.concatenate([b.asnumpy() for b in loader]), x)
    loader.close()
    assert "mxnet_tpu_torch.gluon.data.dataloader" in \
        forkserver._forkserver._preload_modules


def test_unpicklable_dataset_falls_back_to_threads():
    x, _ = _arrays(8)
    ds = tdata.ArrayDataset(x).transform(lambda a: a + 1)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        loader = tdata.DataLoader(ds, batch_size=4, num_workers=2)
        batches = [b.asnumpy() for b in loader]
        loader.close()
    assert len(batches) == 2
    np.testing.assert_array_equal(batches[0], x[:4] + 1)
    assert any("thread pool" in str(m.message) for m in w)
    with pytest.raises(ValueError):
        tdata.DataLoader(ds, batch_size=4, shuffle=True,
                         batch_sampler=object())
    dl = tdata.DataLoader.__new__(tdata.DataLoader)
    dl.__del__()


class _Slow(tdata.Dataset):
    def __init__(self, n=24):
        self._x = np.random.RandomState(0).randn(n, 3).astype(np.float32)

    def __len__(self):
        return len(self._x)

    def __getitem__(self, i):
        time.sleep(0.001)
        return self._x[i], np.float32(i)


def test_prefetch_yields_identical_batches_in_order(monkeypatch):
    ds = _Slow()
    want = _loader_batches(tdata.DataLoader(ds, batch_size=5))
    assert len(want) == 5
    with tmx.cpu():
        for kw in ({"prefetch": 3}, {"device_prefetch": 2},
                   {"prefetch": 2, "device_prefetch": 3}):
            got = _loader_batches(tdata.DataLoader(ds, batch_size=5, **kw))
            assert len(got) == len(want)
            for (a, b), (c, d) in zip(got, want):
                assert (a == c).all() and (b == d).all(), kw
    monkeypatch.setenv("MXNET_TPU_DATA_PREFETCH", "2")
    assert tdata.DataLoader(ds, batch_size=4)._device_prefetch == 2
    assert tdata.default_prefetch_depth() == 2
    assert tdata.DataLoader(ds, batch_size=4, prefetch=3)._prefetch == 3
    assert tdata.DataLoader(ds, batch_size=4, num_workers=2,
                            thread_pool=True)._prefetch == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdata.DevicePrefetchIter(iter([]), depth=2)
        with pytest.raises(RuntimeError, match="needs CUDA"):
            tdata.DataLoader(ds, batch_size=4, pin_memory=True)


def test_prefetch_overlaps_and_surfaces_errors():
    n, delay = 12, 0.02

    def slow():
        for i in range(n):
            time.sleep(delay)
            yield nd.array(np.full((2, 2), i, np.float32), ctx="cpu")

    def epoch(source):
        t0 = time.monotonic()
        seen = []
        for b in source:
            time.sleep(delay)
            seen.append(int(b.asnumpy()[0, 0]))
        return time.monotonic() - t0, seen

    for _ in range(3):
        serial, a = epoch(slow())
        overlapped, b = epoch(tdata.DevicePrefetchIter(slow(), depth=2,
                                                       ctx=tmx.cpu()))
        assert a == b == list(range(n))
        if overlapped < 0.85 * serial:
            break
    else:
        pytest.fail(f"no overlap: {overlapped:.3f}s vs {serial:.3f}s")

    def bad():
        yield nd.zeros((3,), ctx="cpu")
        raise RuntimeError("decode failed")
    it = iter(tdata.DevicePrefetchIter(bad(), depth=2, ctx="cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


class _Batch:
    def __init__(self, data, label):
        self.data, self.label = data, label


def test_stage_batch_keeps_structure_and_values():
    from mxnet_tpu_torch.ndarray import sparse
    a = nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), ctx="cpu")
    t = torch.arange(4.)
    rsp = sparse.row_sparse_array(
        (np.ones((1, 3), np.float32), np.array([1])), shape=(4, 3),
        ctx="cpu")
    batch = {"x": a, "t": t, "meta": ("tag", 7), "ys": [a, np.ones(2)],
             "sparse": rsp}
    staged = tdata.stage_batch(batch, tmx.cpu())
    np.testing.assert_array_equal(staged["x"].asnumpy(), a.asnumpy())
    assert torch.equal(staged["t"], t) and staged["meta"] == ("tag", 7)
    assert isinstance(staged["ys"][1], np.ndarray)
    assert staged["sparse"] is rsp and not rsp.densified
    b1 = tdata.stage_batch(_Batch([a], None), "cpu")
    assert b1.label is None and b1.data[0].context == tmx.cpu()
    b2 = tdata.stage_batch(_Batch((a,), (a,)), "cpu")
    np.testing.assert_array_equal(b2.label[0].asnumpy(), a.asnumpy())


def test_prefetch_metrics_registered():
    from mxnet_tpu_torch.observability import get_registry
    x, y = _arrays(8)
    with tmx.cpu():
        list(tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=4,
                              device_prefetch=2))
    text = get_registry().expose()
    for name in ("mxtpu_data_prefetch_batches_total",
                 "mxtpu_data_prefetch_depth",
                 "mxtpu_data_prefetch_queue_fill",
                 "mxtpu_data_prefetch_wait_seconds"):
        assert name in text


TRANSFORMS = [
    ("Resize", ((8, 6),)), ("Resize", ((30, 20),)), ("Resize", (7, True)),
    ("Resize", ((8, 6), False, 0)), ("CenterCrop", (5,)),
    ("CenterCrop", ((20, 20),)), ("ToTensor", ()),
    ("Normalize", ((0.5, 0.4, 0.3), (0.2, 0.2, 0.2))),
    ("RandomResizedCrop", (8,)), ("RandomCrop", (8, 2)),
    ("RandomFlipLeftRight", ()), ("RandomFlipTopBottom", ()),
    ("RandomColorJitter", (0.3, 0.3, 0.3, 0.1)), ("RandomLighting", (0.1,)),
    ("Cast", ("float16",)),
]


@pytest.mark.parametrize("case", range(len(TRANSFORMS)),
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(TRANSFORMS)])
def test_transforms_match_jax(case):
    cls, args = TRANSFORMS[case]
    img = np.random.RandomState(4).randint(0, 255, (13, 17, 3)).astype(
        np.uint8)
    x = img.transpose(2, 0, 1).astype(np.float32) if cls == "Normalize" \
        else img
    np.random.seed(3)
    want = getattr(jtf, cls)(*args)(x).asnumpy()
    np.random.seed(3)
    got = getattr(ttf, cls)(*args)(x)
    assert isinstance(got, tmx.NDArray) and got.context == tmx.cpu()
    got = got.asnumpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= TRANSFORM_TOL * 255, err
    compose = ttf.Compose([ttf.ToTensor(), ttf.Normalize(0.5, 0.25)])
    out, label = compose(img, 3)
    np.testing.assert_array_equal(
        out.asnumpy(), jtf.Compose([jtf.ToTensor(), jtf.Normalize(
            0.5, 0.25)])(img, 3)[0].asnumpy())
    assert label == 3


def test_split_and_load_and_split_data_match_jax():
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    for n, even in ((2, True), (3, False), (12, False)):
        got = split_data(nd.array(x, ctx="cpu"), n, even_split=even)
        want = jgluon.utils.split_data(jmx.nd.array(x), n, even_split=even)
        assert [g.asnumpy().tolist() for g in got] == \
            [w.asnumpy().tolist() for w in want]
    with pytest.raises(ValueError):
        split_data(torch.from_numpy(x), 3)
    assert [tuple(s.shape) for s in split_data(torch.from_numpy(x), 5,
                                               batch_axis=0)] == [(2, 3)] * 5
    parts = split_and_load(x, [tmx.cpu(0), tmx.cpu(1)])
    want = jgluon.utils.split_and_load(x, [jmx.cpu(0), jmx.cpu(1)])
    for p, w in zip(parts, want):
        assert p.context == tmx.cpu()
        np.testing.assert_array_equal(p.asnumpy(), w.asnumpy())
    assert split_and_load(x, ["cpu"])[0].shape == (10, 3)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_global_norm_matches_jax(max_norm):
    rs = np.random.RandomState(5)
    arrays = [rs.randn(4, 3).astype(np.float32), rs.randn(7).astype(
        np.float32)]
    jarr = [jmx.nd.array(a) for a in arrays]
    tarr = [nd.array(arrays[0], ctx="cpu"), torch.from_numpy(arrays[1])]
    want = jgluon.utils.clip_global_norm(jarr, max_norm)
    got = clip_global_norm(tarr, max_norm)
    assert isinstance(got, float)
    assert abs(got - want) <= CLIP_TOL * want
    for a, b in zip(_np(tarr), _np(jarr)):
        np.testing.assert_allclose(a, b, rtol=CLIP_TOL, atol=0)
    t = torch.tensor([3.0, 4.0])
    norm = clip_global_norm([t], 1.0, check_isfinite=False)
    assert isinstance(norm, torch.Tensor) and float(norm) == 5.0
    with pytest.warns(UserWarning, match="nan or inf"):
        clip_global_norm([torch.tensor([np.inf, 1.0])], 1.0)

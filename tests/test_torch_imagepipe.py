"""PyTorch port, the native decode/augment pool
(``mxnet_tpu_torch/image/native_iter.py`` over
``mxnet_tpu_torch/native/src/imagepipe_native.cpp``) against the JAX
package:

- the 13 cases of the JAX suite's ``tests/test_native_imagepipe.py`` run
  through the port by text substitution (its ``rec20`` records made by
  its own ``_make_rec``);
- on the same records and seed, ``ImageRecordIterNative`` gives the JAX
  package's batches bit for bit (shuffled, cropped, mirrored, resized,
  normalized, NCHW and NHWC, sharded, over an epoch boundary), and
  ``MXDataIter("ImageRecordIter", ...)`` picks the same iterator in both.
"""
import importlib.util
import inspect
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402

torch.set_num_threads(2)


def _symbol_tests():
    spec = importlib.util.spec_from_file_location(
        "_torch_symbol_cases_pipe", os.path.join(HERE,
                                                 "test_torch_symbol.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SYM = _symbol_tests()
CASES = SYM.load_reference_tests("test_native_imagepipe")


@pytest.fixture(scope="module")
def rec20(tmp_path_factory):
    make = next(iter(CASES.values())).__globals__["_make_rec"]
    prefix = str(tmp_path_factory.mktemp("port_native_pipe") / "data")
    return prefix, make(prefix, 20)


def test_the_reference_has_thirteen_cases():
    assert len(CASES) == 13


@pytest.mark.parametrize("name", list(CASES))
def test_reference_pipeline_case_through_the_port(name, request):
    fn = CASES[name]
    kw = {p: request.getfixturevalue(p)
          for p in inspect.signature(fn).parameters}
    np.random.seed(0)
    tmx.random.seed(0)
    with tmx.cpu():
        fn(**kw)


def _jpeg_records(prefix, rec_mod, n=22, hw=(40, 30)):
    rng = np.random.RandomState(4)
    w = rec_mod.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
        w.write_idx(i, rec_mod.pack_img(
            rec_mod.IRHeader(0, float(i % 7), i, 0), img, quality=90,
            img_fmt=".jpg"))
    w.close()


@pytest.mark.parametrize("kw", [
    dict(data_shape=(3, 24, 24), shuffle=True, rand_crop=True,
         rand_mirror=True, seed=5),
    dict(data_shape=(3, 20, 20), resize=28, rand_crop=True,
         mean=(120.0, 110.0, 100.0), std=(60.0, 55.0, 50.0), seed=1,
         preprocess_threads=3),
    dict(data_shape=(24, 24, 3), layout="NHWC", rand_mirror=True,
         shuffle=True, num_parts=2, part_index=1),
    dict(data_shape=(3, 16, 16), last_batch_handle="discard",
         shuffle=True, rand_crop=True, seed=9)],
    ids=["crop-mirror", "resize-normalize", "nhwc-shard", "discard"])
def test_native_batches_are_the_jax_packages_bit_for_bit(kw, tmp_path):
    prefix = str(tmp_path / "r")
    _jpeg_records(prefix, tmx.recordio)
    got = {}
    for mx in (jmx, tmx):
        with tmx.cpu():         # the port's batches on the CPU
            it = mx.image.ImageRecordIterNative(
                path_imgrec=prefix + ".rec", batch_size=6,
                **({"preprocess_threads": 2} | kw))
            got[mx] = []
            for _ in range(2):      # two epochs: the reshuffle too
                got[mx].append([(b.data[0].asnumpy(),
                                 b.label[0].asnumpy(), b.pad) for b in it])
                it.reset()
        it.close()
    assert len(got[tmx][0]) == len(got[jmx][0]) > 1
    for et, ej in zip(got[tmx], got[jmx]):
        for (td, tl, tp), (jd, jl, jp) in zip(et, ej):
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(tl, jl)
            assert tp == jp


def test_mxdataiter_picks_the_same_iterator(tmp_path):
    prefix = str(tmp_path / "d")
    _jpeg_records(prefix, tmx.recordio, n=8)
    for extra, want in (({"preprocess_threads": 2, "mean_r": 1.0},
                         "ImageRecordIterNative"),
                        ({"brightness": 0.3}, "ImageIter"),
                        ({"last_batch_handle": "roll_over"}, "ImageIter")):
        kw = dict(path_imgrec=prefix + ".rec", data_shape=(3, 16, 16),
                  batch_size=4, **extra)
        with tmx.cpu():
            t = tmx.io.MXDataIter("ImageRecordIter", **kw)
        j = jmx.io.MXDataIter("ImageRecordIter", **kw)
        assert type(t).__name__ == type(j).__name__ == want

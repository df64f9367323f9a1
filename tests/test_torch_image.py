"""PyTorch port, images (``mxnet_tpu_torch/image``, ``im2rec.py``,
``examples/train_imagenet.py`` on records) against the JAX package on
the same inputs and seeds (both draw from Python's ``random`` and, for
``LightingAug``, numpy's, in the same order):

- every augmenter and image function: crops, flips, resizes and casts
  bit for bit, the float passes (jitter, hue, lighting, gray,
  normalization) within 1e-6 relative to the largest value;
- ``ImageIter`` over a ``.rec`` and over a ``.lst`` with every
  ``CreateAugmenter`` option, and ``ImageDetIter`` with
  ``CreateDetAugmenter``: the same batches (the same tolerances);
- ``python -m mxnet_tpu_torch.im2rec`` writes the ``.lst``, ``.rec`` and
  ``.idx`` bytes ``tools/im2rec.py`` writes (its test's case);
- ``train_imagenet.main`` with ``--data-train``/``--data-val`` on
  ``tests/test_train_imagenet.py``'s 32 JPEGs at 24 x 24 (ResNet-18, 4
  classes, batch 32), both packages from one epoch-0 checkpoint: the same
  batches bit for bit, the classifier's parameters after the epoch
  within ``tests/test_torch_module.py``'s rtol 1e-4 / atol 1e-5 and the
  deeper ones within ``tests/test_torch_resnet.py``'s bounds (the ReLU
  gates that flip at f32 ties: see ``UPDATE_RTOL``).
"""
import os
import random
import shutil
import subprocess
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

FLOAT_REL_TOL = 1e-6
# train_imagenet.py on records, at batch 32 (the epoch one step of all 32
# records): the classifier's parameters after the epoch to
# tests/test_torch_module.py's rtol / atol. Below it, the bounds of
# tests/test_torch_resnet.py, for the same reason: a ReLU gate whose
# input is within f32 rounding of 0 flips between the packages (measured
# at batch 8: 1 of 36864 gates at stage 4, 3 of 73728 at stage 3), and at
# 3 x 3 positions a channel one gate is 1/(9 x batch) of its channel's
# gradient, mixed across the layer by the training-mode BatchNorm. At
# batch 8 the deep weight gradients then differ by 1-13% at those layers
# (fc1's agree to 2e-5, a conv + BatchNorm + ReLU layer alone to 4e-6),
# and over 4 steps the updates by up to 59%; at batch 32, in one step, by
# 2.2% at most (fc1's by 1.4e-5). Each parameter's update is held to
# UPDATE_RTOL in the 2-norm and the running statistics to STAT_RTOL.
RTOL, ATOL = 1e-4, 1e-5
UPDATE_RTOL, STAT_RTOL = 0.15, 2e-3
BATCH = "32"
IMG = np.random.RandomState(0).randint(0, 256, (36, 28, 3)).astype(np.uint8)
EIGVAL = np.array([55.46, 4.794, 1.148])
EIGVEC = np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                   [-0.5836, -0.6948, 0.4203]])
MEAN = np.array([123.68, 116.28, 103.53])
STD = np.array([58.395, 57.12, 57.375])


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(a, b, exact):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        err = np.abs(a.astype(np.float64) - b).max() / max(
            np.abs(b).max(), 1e-30)
        assert err <= FLOAT_REL_TOL, err


def _both(make, seeds=(0, 1, 2, 3)):
    """``make(mx)`` in each package, from the same seeds: the outputs."""
    out = {}
    for mx in (jmx, tmx):
        got = []
        for s in seeds:
            random.seed(s)
            np.random.seed(s)
            with tmx.cpu():
                got.append(make(mx))
        out[mx] = got
    return out[tmx], out[jmx]


AUGMENTERS = [
    ("ResizeAug", lambda m: m.ResizeAug(20), True),
    ("ForceResizeAug", lambda m: m.ForceResizeAug((30, 20)), True),
    ("RandomCropAug", lambda m: m.RandomCropAug((16, 16)), True),
    ("RandomSizedCropAug", lambda m: m.RandomSizedCropAug(
        (16, 16), (0.3, 1.0), (0.75, 1.33)), True),
    ("CenterCropAug", lambda m: m.CenterCropAug((16, 20)), True),
    ("HorizontalFlipAug", lambda m: m.HorizontalFlipAug(0.5), True),
    ("CastAug", lambda m: m.CastAug(), True),
    ("ColorNormalizeAug", lambda m: m.ColorNormalizeAug(MEAN, STD), False),
    ("BrightnessJitterAug", lambda m: m.BrightnessJitterAug(0.3), False),
    ("ContrastJitterAug", lambda m: m.ContrastJitterAug(0.3), False),
    ("SaturationJitterAug", lambda m: m.SaturationJitterAug(0.3), False),
    ("HueJitterAug", lambda m: m.HueJitterAug(0.2), False),
    ("ColorJitterAug", lambda m: m.ColorJitterAug(0.2, 0.2, 0.2), False),
    ("LightingAug", lambda m: m.LightingAug(0.1, EIGVAL, EIGVEC), False),
    ("RandomGrayAug", lambda m: m.RandomGrayAug(0.5), False),
    ("RandomOrderAug", lambda m: m.RandomOrderAug(
        [m.RandomCropAug((20, 20)), m.HorizontalFlipAug(0.5),
         m.CastAug()]), True),
    ("SequentialAug", lambda m: m.SequentialAug(
        [m.ResizeAug(24), m.CenterCropAug((16, 16)), m.CastAug(),
         m.BrightnessJitterAug(0.2)]), False),
]


@pytest.mark.parametrize("name,make,exact", AUGMENTERS,
                         ids=[a[0] for a in AUGMENTERS])
def test_augmenters_are_the_jax_packages(name, make, exact):
    t, j = _both(lambda mx: make(mx.image)(mx.nd.array(IMG)))
    for a, b in zip(t, j):
        _same(a, b, exact)
    assert _dumps(make(tmx.image)) == _dumps(make(jmx.image))


def _dumps(aug):
    try:
        return aug.dumps()
    except TypeError as e:      # an array among the kwargs, in both
        return repr(e)


def test_image_functions_are_the_jax_packages(tmp_path):
    import cv2
    ok, png = cv2.imencode(".png", IMG)
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, IMG)
    cases = [
        (lambda m: m.imdecode(png.tobytes()), True),
        (lambda m: m.imdecode(png.tobytes(), flag=0), True),
        (lambda m: m.imread(path), True),
        (lambda m: m.imresize(m_img(m), 17, 23, interp=2), True),
        (lambda m: m.resize_short(m_img(m), 20), True),
        (lambda m: m.fixed_crop(m_img(m), 3, 5, 10, 12, size=(8, 8)), True),
        (lambda m: m.center_crop(m_img(m), (12, 10))[0], True),
        (lambda m: m.random_crop(m_img(m), (12, 10))[0], True),
        (lambda m: m.random_size_crop(m_img(m), (10, 10), 0.2,
                                      (0.5, 2.0))[0], True),
        (lambda m: m.color_normalize(m_img(m), MEAN, STD), False),
    ]

    def m_img(m):
        return (jmx if m is jmx.image else tmx).nd.array(IMG)
    for make, exact in cases:
        t, j = _both(lambda mx: make(mx.image))
        for a, b in zip(t, j):
            _same(a, b, exact)


def _rec(rec_mod, prefix, n=10, hw=(30, 26), det=False, fmt=".png"):
    rs = np.random.RandomState(2)
    w = rec_mod.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        img = rs.randint(0, 256, hw + (3,)).astype(np.uint8)
        if det:
            boxes = []
            for _ in range(1 + i % 3):
                x0, y0 = rs.uniform(0, 0.5, 2)
                boxes += [float(i % 4), x0, y0, x0 + 0.4, y0 + 0.3]
            label = np.array([2, 5] + boxes, np.float32)
        else:
            label = float(i % 4)
        w.write_idx(i, rec_mod.pack_img(rec_mod.IRHeader(0, label, i, 0),
                                        img, img_fmt=fmt))
    w.close()


def _batches(it, n):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
            for b in (it.next() for _ in range(n))]


def test_image_iter_over_a_rec_with_every_option(tmp_path):
    prefix = str(tmp_path / "i")
    _rec(tmx.recordio, prefix)
    opts = dict(resize=28, rand_crop=True, rand_mirror=True, mean=True,
                std=True, brightness=0.2, contrast=0.2, saturation=0.2,
                hue=0.1, pca_noise=0.1, rand_gray=0.3)
    for kw in (opts, dict(opts, rand_resize=True, rand_crop=False)):
        t, j = _both(lambda mx: _batches(mx.image.ImageIter(
            4, (3, 20, 20), path_imgrec=prefix + ".rec", shuffle=True,
            **kw), 3), seeds=(5,))
        for (td, tl, tp), (jd, jl, jp) in zip(t[0], j[0]):
            _same(td, jd, False)
            np.testing.assert_array_equal(tl, jl)
            assert tp == jp
    # crops, flips and casts alone: bit for bit
    t, j = _both(lambda mx: _batches(mx.image.ImageIter(
        4, (3, 20, 20), path_imgrec=prefix + ".rec", shuffle=True,
        rand_crop=True, rand_mirror=True), 3), seeds=(6,))
    for (td, tl, tp), (jd, jl, jp) in zip(t[0], j[0]):
        np.testing.assert_array_equal(td, jd)
        assert tp == jp


def test_image_iter_over_a_list(tmp_path):
    import cv2
    rs = np.random.RandomState(3)
    with open(tmp_path / "x.lst", "w") as f:
        for i in range(6):
            cv2.imwrite(str(tmp_path / f"{i}.png"),
                        rs.randint(0, 256, (22, 22, 3)).astype(np.uint8))
            f.write(f"{i}\t{i % 3}\t{i}.png\n")
    t, j = _both(lambda mx: _batches(mx.image.ImageIter(
        4, (3, 16, 16), path_imglist=str(tmp_path / "x.lst"),
        path_root=str(tmp_path), rand_crop=True, rand_mirror=True,
        shuffle=True), 2), seeds=(2,))
    for (td, tl, tp), (jd, jl, jp) in zip(t[0], j[0]):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
        assert tp == jp == (0 if tp == 0 else 2)


def test_image_det_iter_and_det_augmenters(tmp_path):
    prefix = str(tmp_path / "d")
    _rec(tmx.recordio, prefix, n=7, det=True)
    for kw, exact in ((dict(rand_mirror=True), True),
                      (dict(rand_mirror=True, mean=True, std=True), False)):
        t, j = _both(lambda mx: _batches(mx.image.ImageDetIter(
            3, (3, 24, 24), path_imgrec=prefix + ".rec", shuffle=True,
            max_objects=4, **kw), 3), seeds=(1, 4))
        for tb, jb in zip(t, j):
            for (td, tl, tp), (jd, jl, jp) in zip(tb, jb):
                _same(td, jd, exact)
                np.testing.assert_array_equal(tl, jl)
                assert tl.shape == (3, 4, 5) and tp == jp
    lab = np.array([[1, 0.1, 0.2, 0.5, 0.6], [-1, -1, -1, -1, -1]],
                   np.float32)
    t, j = _both(lambda mx: mx.image.DetHorizontalFlipAug(0.5)(
        mx.nd.array(IMG), lab))
    for (ti, tl), (ji, jl) in zip(t, j):
        _same(ti, ji, True)
        np.testing.assert_array_equal(tl, jl)


def test_record_datasets_are_the_jax_packages(tmp_path):
    prefix = str(tmp_path / "ds")
    _rec(tmx.recordio, prefix, n=5, fmt=".jpg")
    tdata, jdata = tmx.gluon.data, jmx.gluon.data
    t = tdata.vision.ImageRecordDataset(prefix + ".rec", flag=0)
    j = jdata.vision.ImageRecordDataset(prefix + ".rec", flag=0)
    assert len(t) == len(j) == 5
    for i in range(5):
        (ti, tl), (ji, jl) = t[i], j[i]
        assert ti.context == tmx.cpu() and ti.shape == (30, 26)
        np.testing.assert_array_equal(ti.asnumpy(), ji.asnumpy())
        assert tl == jl
    raw = tdata.RecordFileDataset(prefix + ".rec")
    assert [raw[i] for i in range(5)] == [
        jdata.RecordFileDataset(prefix + ".rec")[i] for i in range(5)]


def _run(args, cwd):
    r = subprocess.run([sys.executable, *args], capture_output=True,
                       text=True, cwd=cwd,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr


def test_im2rec_writes_the_tools_bytes(tmp_path):
    import cv2
    rng = np.random.RandomState(0)
    for cls in ("cat", "dog"):
        d = tmp_path / "imgs" / cls
        d.mkdir(parents=True)
        for i in range(3):
            cv2.imwrite(str(d / f"{i}.jpg"),
                        (rng.rand(40, 40, 3) * 255).astype(np.uint8))
    imgs = str(tmp_path / "imgs")
    tool = os.path.join(ROOT, "tools", "im2rec.py")
    for who, cmd in (("j", [tool]), ("t", ["-m", "mxnet_tpu_torch.im2rec"])):
        prefix = str(tmp_path / who)
        _run(cmd + ["--list", "--recursive", prefix, imgs], ROOT)
        _run(cmd + [prefix, imgs, "--resize", "32"], ROOT)
    for ext in (".lst", ".rec", ".idx"):
        assert (tmp_path / ("t" + ext)).read_bytes() == \
            (tmp_path / ("j" + ext)).read_bytes(), ext
    assert len((tmp_path / "t.lst").read_text().splitlines()) == 6
    rd = tmx.recordio.MXIndexedRecordIO(str(tmp_path / "t.idx"),
                                        str(tmp_path / "t.rec"), "r")
    hdr, img = tmx.recordio.unpack_img(rd.read_idx(rd.keys[0]))
    assert min(img.shape[:2]) == 32
    rd.close()


def _imagenet_example(mx):
    import re
    import types
    path = os.path.join(ROOT, "examples", "train_imagenet.py")
    src = open(path).read()
    if mx is tmx:
        src = re.sub(r"\bmxnet_tpu\b", "mxnet_tpu_torch", src)
    mod = types.ModuleType(f"_train_imagenet_{mx.__name__}_rec")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


@pytest.fixture(scope="module")
def imagenet_recs(tmp_path_factory):
    """tests/test_train_imagenet.py's records: 32 train and 16 val JPEGs
    at 24 x 24, 4 classes."""
    d = tmp_path_factory.mktemp("port_imagenet_rec")
    rng = np.random.RandomState(0)
    for name, n in (("train", 32), ("val", 16)):
        rec = tmx.recordio.MXIndexedRecordIO(str(d / f"{name}.idx"),
                                             str(d / f"{name}.rec"), "w")
        for i in range(n):
            img = rng.randint(0, 255, (24, 24, 3), dtype=np.uint8)
            rec.write_idx(i, tmx.recordio.pack_img(
                tmx.recordio.IRHeader(0, float(i % 4), i, 0), img,
                quality=90, img_fmt=".jpg"))
        rec.close()
    return d


def test_train_imagenet_on_records_matches_the_reference(imagenet_recs,
                                                         tmp_path):
    d = imagenet_recs
    argv = ["--data-train", str(d / "train.rec"), "--data-val",
            str(d / "val.rec"), "--network", "resnet", "--num-layers", "18",
            "--num-classes", "4", "--image-shape", "3,24,24",
            "--batch-size", BATCH, "--num-examples", "32", "--num-epochs", "1",
            "--lr", "0.05", "--lr-step-epochs", "", "--kv-store", "local",
            "--disp-batches", "2", "--top-k", "2"]
    ex = {mx: _imagenet_example(mx) for mx in (jmx, tmx)}
    # one epoch-0 checkpoint, written by the JAX package, starts both
    jsym = ex[jmx].get_resnet_symbol(4, 18, (3, 24, 24))
    jmod = jmx.mod.Module(jsym)
    jmod.bind(data_shapes=[("data", (int(BATCH), 3, 24, 24))],
              label_shapes=[("softmax_label", (int(BATCH),))])
    jmx.random.seed(0)
    jmod.init_params(initializer=jmx.initializer.Xavier(
        rnd_type="gaussian", factor_type="in", magnitude=2))
    jmod.save_checkpoint(str(tmp_path / "j"), 0)
    for f in ("-symbol.json", "-0000.params"):
        shutil.copy(str(tmp_path / ("j" + f)), str(tmp_path / ("t" + f)))
    # the batches: the same bits from both packages' iterators
    import argparse
    got = {}
    for mx in (jmx, tmx):
        ns = ex[mx].add_args(argparse.ArgumentParser()).parse_args(argv)
        ns.image_shape_t = (3, 24, 24)
        with tmx.cpu():
            train, val = ex[mx].get_rec_iter(ns, mx.kv.create("local"))
            got[mx] = [(b.data[0].asnumpy(), b.label[0].asnumpy())
                       for it in (train, val) for b in it]
    assert len(got[tmx]) == -(-32 // int(BATCH)) - (-16 // int(BATCH))
    for (td, tl), (jd, jl) in zip(got[tmx], got[jmx]):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
    params = {}
    for mx, who in ((jmx, "j"), (tmx, "t")):
        with tmx.cpu():
            mod = ex[mx].main(argv + ["--model-prefix",
                                      str(tmp_path / who), "--load-epoch",
                                      "0"])
        assert os.path.exists(str(tmp_path / f"{who}-0001.params"))
        params[mx] = mod.get_params()
    (ta, tx), (ja, jx) = params[tmx], params[jmx]
    assert sorted(ta) == sorted(ja) and sorted(tx) == sorted(jx)
    _, start, _ = jmx.model.load_checkpoint(str(tmp_path / "j"), 0)
    errs = {}
    for k in ja:
        # each parameter's update over the epoch, port against JAX
        want = ja[k].asnumpy() - start[k].asnumpy()
        got = ta[k].asnumpy() - start[k].asnumpy()
        errs[k] = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert max(errs.values()) <= UPDATE_RTOL, max(errs.items(),
                                                  key=lambda kv: kv[1])
    # the classifier, above every ReLU gate: test_torch_module's bound
    for k in ("fc1_weight", "fc1_bias"):
        np.testing.assert_allclose(ta[k].asnumpy(), ja[k].asnumpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for k in jx:
        err = np.linalg.norm(tx[k].asnumpy() - jx[k].asnumpy()) / \
            np.linalg.norm(jx[k].asnumpy())
        assert err <= STAT_RTOL, (k, err)
    # the port's checkpoint reloads and scores the val records
    with tmx.cpu():
        sym, args, auxs = tmx.model.load_checkpoint(str(tmp_path / "t"), 1)
        scored = tmx.mod.Module(symbol=sym,
                                context=tmx.context.current_context())
        val = tmx.io.MXDataIter("ImageRecordIter",
                                path_imgrec=str(d / "val.rec"),
                                data_shape=(3, 24, 24), batch_size=8)
        scored.bind(data_shapes=val.provide_data,
                    label_shapes=val.provide_label, for_training=False)
        scored.set_params(args, auxs)
        acc = dict(scored.score(val, tmx.metric.create("accuracy")))
    assert 0.0 <= acc["accuracy"] <= 1.0

"""PyTorch port, the vision slice against the JAX package, ResNet-50:
one SGD-momentum step at 64x64, batch 2, with ``bench.py``'s loss
(weights through ``convert.load_gluon_params``), and the NHWC net with
the space-to-depth stem against the NCHW net on the same weights (the
helpers and tolerances of tests/test_torch_resnet.py, loaded by path)."""
import importlib.util
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon.model_zoo import vision as jvision

from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.convert import load_gluon_params
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

torch.set_num_threads(2)
_spec = importlib.util.spec_from_file_location(
    "_resnet_main", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "test_torch_resnet.py"))
_main = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_main)
_batches, _train_both, _check_training = (
    _main._batches, _main._train_both, _main._check_training)
LAYOUT_RTOL = _main.LAYOUT_RTOL


def test_resnet50_one_step_matches_jax():
    batches = _batches(1, 2, 64, seed=1)
    j = jvision.resnet50_v1(classes=10, prefix="r50_")
    j.initialize(jmx.initializer.Xavier())
    with jag.pause():
        j(jmx.nd.array(batches[0][0]))
    t = tvision.resnet50_v1(classes=10, prefix="r50_")
    t.initialize(device="cpu")
    with tag.pause():
        t(torch.from_numpy(batches[0][0]))
    load_gluon_params(t, {k: v.data().asnumpy()
                          for k, v in j.collect_params().items()})
    losses, before = _train_both(j, t, batches)
    _check_training(j, t, losses, before, first_rtol=1e-3)


def test_resnet50_nhwc_s2d_stem_matches_nchw():
    x = np.random.RandomState(2).randn(2, 3, 64, 64).astype(np.float32)
    a = tvision.resnet50_v1(classes=10, prefix="nchw_")
    a.initialize(device="cpu", generator=torch.Generator().manual_seed(0))
    b = tvision.resnet50_v1(classes=10, layout="NHWC", stem_s2d=True,
                            prefix="nhwc_")
    b.initialize(device="cpu")
    with tag.pause():
        want = a(torch.from_numpy(x)).numpy()
        b(torch.from_numpy(x.transpose(0, 2, 3, 1).copy()))
    src = a._collect_params_with_prefix()
    dst = b._collect_params_with_prefix()
    assert list(src) == list(dst)
    assert tuple(dst["features.0.weight"].shape) == (64, 7, 7, 3)
    for key, p in dst.items():
        w = src[key].data().detach()
        p.set_data(w.permute(0, 2, 3, 1) if w.ndim == 4 else w)
    with tag.pause():
        got = b(torch.from_numpy(x.transpose(0, 2, 3, 1).copy())).numpy()
    assert np.abs(got - want).max() <= LAYOUT_RTOL * np.abs(want).max()
    with pytest.raises(AssertionError, match="NHWC"):
        tvision.resnet50_v1(stem_s2d=True, prefix="bad_")

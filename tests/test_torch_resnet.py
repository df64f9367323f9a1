"""PyTorch port, the vision slice end to end against the JAX package:
ResNet training with ``bench.py``'s loss (per-sample NLL of the f32
log-softmax, ``pick``) and SGD with momentum through gluon and the
``Trainer``, on the JAX net's weights.

- ``resnet18_v1(thumbnail=True)`` at 32x32, batch 4: three steps (the
  weights through the file route: JAX ``save_parameters`` → port
  ``load_parameters``);
- ``resnet50_v1`` at 64x64, batch 2: one step (weights through
  ``convert.load_gluon_params``), and ``resnet50_v1(layout="NHWC",
  stem_s2d=True)`` against the NCHW net on the same weights (OIHW →
  OHWI): ``tests/test_torch_resnet2.py``;
- the bf16 cast: every parameter's dtype as the JAX net's (BatchNorm's
  stay f32) and the forward within bf16's tolerance;
- ``load_gluon_params`` of an NHWC net (OHWI weights, ``grad_req="null"``
  running statistics) and of a ``Constant``.

Tolerances, with their reasons:
- ``LOSS_RTOL = 2e-3`` per sample: the first step's loss agrees to ~1e-6;
  later ones move by what the updates below move;
- the first step's loss: ``rtol=1e-5`` (the forward alone), 1e-3 for
  ResNet-50 at 64x64 and batch 2, whose last stage normalises 8 values
  a channel (2 x 2 x 2) by E[x^2] - E[x]^2, a cancellation that
  amplifies the f32 rounding (2.3e-4 measured);
- ``UPDATE_RTOL = 0.15``: each parameter's total update, |port - JAX| /
  |JAX| in the 2-norm. A ReLU gate that flips at a tie (its input within
  f32 rounding of 0, ~1e-6: a handful of the 10^5 gates of a step)
  moves one whole gradient entry, and through the training-mode
  BatchNorms, which mix every position of a channel, the updates before
  it: 2-7% at batch 4 (measured over three seeds), where the port in
  f64 agrees with the JAX package in f32 to 4e-6 on a step without a
  flip. The biases of convolutions under a BatchNorm have a zero
  gradient in exact arithmetic; their updates, rounding noise below
  ``ZERO_GRAD = 1e-5`` of the largest update, are held to that bound;
- ``STAT_RTOL = 2e-3``: the running statistics, in the 2-norm: the
  forwards after the first step run on weights that differ as their
  updates do (4e-4 measured);
- ``LAYOUT_RTOL = 1e-4`` of the logits' magnitude (the same convolutions
  summed in another order);
- ``BF16_RTOL = 3e-2`` of the logits' magnitude: 8-bit mantissas (2^-8
  each rounding) through 18 layers, the two packages rounding at
  different ops (XLA keeps fused chains in f32).
"""
import os

import numpy as np
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import Trainer as JTrainer
from mxnet_tpu.gluon.model_zoo import vision as jvision

from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.convert import load_gluon_params
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

torch.set_num_threads(2)

LOSS_RTOL = 2e-3
UPDATE_RTOL = 0.15
ZERO_GRAD = 1e-5
STAT_RTOL = 2e-3
LAYOUT_RTOL = 1e-4
BF16_RTOL = 3e-2
SGD = {"learning_rate": 1e-3, "momentum": 0.9}


def _jax_loss(net, x, y):
    logp = jmx.nd.log_softmax(net(x).astype("float32"), axis=-1)
    return -jmx.nd.pick(logp, y, axis=1)


def _port_loss(net, x, y):
    logp = tnd.log_softmax(net(x).float(), axis=-1)
    return -tnd.pick(logp, y, axis=1)


def _norm_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    n = np.linalg.norm(want)
    return np.linalg.norm(got - want) / n if n else np.linalg.norm(got)


def _train_both(j, t, batches):
    """The same SGD-momentum steps on both nets; returns each step's
    per-sample losses and the parameters before the first."""
    before = {k: p.data().asnumpy().copy()
              for k, p in j.collect_params().items()}
    jt = JTrainer(j.collect_params(), "sgd", dict(SGD))
    tt = tgluon.Trainer(t.collect_params(), "sgd", dict(SGD))
    losses = []
    for x, y in batches:
        with jag.record():
            jl = _jax_loss(j, jmx.nd.array(x), jmx.nd.array(y))
        jl.backward()
        jt.step(x.shape[0])
        with tag.record():
            tl = _port_loss(t, torch.from_numpy(x), torch.from_numpy(y))
        tl.backward()
        tt.step(x.shape[0])
        losses.append((tl.asnumpy(), jl.asnumpy()))
    assert tt._fused.fallbacks == {} and tt._fused.last_dispatches == 1
    return losses, before


def _check_training(j, t, losses, before, first_rtol=1e-5):
    np.testing.assert_allclose(losses[0][0], losses[0][1], rtol=first_rtol)
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    mine = t.collect_params()
    updates = {}
    for name, p in j.collect_params().items():
        got = mine[name].data().detach().numpy()
        want = p.data().asnumpy()
        if p.grad_req == "null":
            err = _norm_rel(got, want)
            assert err <= STAT_RTOL, (name, err)
        else:
            updates[name] = (got - before[name], want - before[name])
    top = max(np.linalg.norm(w) for _, w in updates.values())
    for name, (got, want) in updates.items():
        if np.linalg.norm(want) < ZERO_GRAD * top:
            err = np.linalg.norm(got - want) / top
            assert err <= ZERO_GRAD, (name, err)
        else:
            err = _norm_rel(got, want)
            assert err <= UPDATE_RTOL, (name, err)


def _batches(n, batch, size, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(batch, 3, size, size).astype(np.float32),
             rs.randint(0, 10, batch).astype(np.int32)) for _ in range(n)]


def test_resnet18_thumbnail_three_sgd_steps_match_jax(tmp_path):
    batches = _batches(3, 4, 32)
    jmx.random.seed(0)
    j = jvision.resnet18_v1(thumbnail=True, classes=10, prefix="r18_")
    j.initialize(jmx.initializer.Xavier())
    with jag.pause():
        j(jmx.nd.array(batches[0][0]))
    path = str(tmp_path / "r18.params")
    j.save_parameters(path)
    t = tvision.resnet18_v1(thumbnail=True, classes=10, prefix="r18_")
    t.load_parameters(path, ctx="cpu")
    losses, before = _train_both(j, t, batches)
    _check_training(j, t, losses, before)


def test_bf16_cast_forward_matches_jax():
    x = np.random.RandomState(3).randn(2, 3, 32, 32).astype(np.float32)
    j = jvision.resnet18_v1(thumbnail=True, classes=10, prefix="bf_")
    j.initialize(jmx.initializer.Xavier())
    with jag.pause():
        j(jmx.nd.array(x))
    t = tvision.resnet18_v1(thumbnail=True, classes=10, prefix="bf_")
    t.initialize(device="cpu")
    with tag.pause():
        t(torch.from_numpy(x))
    load_gluon_params(t, {k: v.data().asnumpy()
                          for k, v in j.collect_params().items()})
    j.cast("bfloat16")
    t.cast("bfloat16")
    jd = {k: str(v.data().dtype) for k, v in j.collect_params().items()}
    td = {k: str(v.data().dtype).replace("torch.", "")
          for k, v in t.collect_params().items()}
    assert td == jd
    assert {v for k, v in td.items() if "batchnorm" in k} == {"float32"}
    assert td["bf_conv2d0_weight"] == "bfloat16"
    with jag.pause():
        want = j(jmx.nd.array(x).astype("bfloat16")).astype(
            "float32").asnumpy()
    with tag.pause():
        got = t(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() <= BF16_RTOL * np.abs(want).max()


def test_load_gluon_params_takes_nhwc_weights_stats_and_constants():
    x = np.random.RandomState(4).randn(2, 16, 16, 3).astype(np.float32)
    j = jvision.resnet18_v1(classes=10, layout="NHWC", prefix="h_")
    j.initialize(jmx.initializer.Xavier())
    with jag.record():        # a training forward moves the statistics
        j(jmx.nd.array(x))
    with jag.pause():
        want = j(jmx.nd.array(x)).asnumpy()
    t = tvision.resnet18_v1(classes=10, layout="NHWC", prefix="h_")
    t.initialize(device="cpu")
    with tag.pause():
        t(torch.from_numpy(x))
    arrays = {k: v.data().asnumpy() for k, v in j.collect_params().items()}
    load_gluon_params(t, arrays)
    assert tuple(t.features[0].weight.shape) == (64, 7, 7, 3)
    stat = "h_batchnorm0_running_mean"
    assert t.collect_params()[stat].grad_req == "null"
    np.testing.assert_array_equal(
        t.collect_params()[stat].data().numpy(), arrays[stat])
    with tag.pause():
        got = t(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= LAYOUT_RTOL * np.abs(want).max()
    from mxnet_tpu.gluon import ParameterDict as JDict
    from mxnet_tpu_torch.gluon import ParameterDict as TDict
    jc = JDict("c_").get_constant("k", np.arange(4.0, dtype=np.float32))
    jc.initialize()

    class Holder(tgluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="c_")
            self.k = self.params.get_constant("k", np.zeros(4, np.float32))
    h = Holder()
    h.initialize(device="cpu")
    assert isinstance(h.params, TDict)
    load_gluon_params(h, {"c_k": jc.data().asnumpy()})
    assert h.k.data().tolist() == [0.0, 1.0, 2.0, 3.0]
    assert os.path.exists(jvision.__file__)

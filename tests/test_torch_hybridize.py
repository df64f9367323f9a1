"""PyTorch port, ``HybridBlock.hybridize`` (``mxnet_tpu_torch/gluon/
block.py`` ``CachedOp``): the cases of ``tests/test_hybridize_sweep.py``
and the cached op's keys and invalidation.

Each sweep case builds the layer in both packages from the JAX layer's
weights (``convert.load_gluon_params``), hybridizes both, and holds the
port's output (and input gradient) against the JAX package's hybridized
layer on the same numpy input, to the sweep's tolerance; and the port's
hybridized call bit for bit against its own eager call. On the CPU a
hybridized port block runs its eager forward under the CachedOp's keys
(the CUDA graphs, one per signature, are held on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 8e).
"""
import os
import sys
import tempfile

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.autograd as jag  # noqa: E402
from mxnet_tpu import nd as jnd  # noqa: E402
from mxnet_tpu.gluon import nn as jnn  # noqa: E402
from mxnet_tpu_torch import autograd as tag  # noqa: E402
from mxnet_tpu_torch.convert import load_gluon_params  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tnn  # noqa: E402

torch.set_num_threads(2)

# the sweep's tolerances (tests/test_hybridize_sweep.py)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

CASES = [
    ("dense", lambda nn: nn.Dense(8, activation="relu"), (4, 6)),
    ("dense_nobias", lambda nn: nn.Dense(5, use_bias=False), (3, 7)),
    ("conv2d", lambda nn: nn.Conv2D(6, 3, padding=1), (2, 3, 8, 8)),
    ("conv2d_nhwc", lambda nn: nn.Conv2D(6, 3, padding=1, layout="NHWC"),
     (2, 8, 8, 3)),
    ("conv1d", lambda nn: nn.Conv1D(4, 3, padding=1), (2, 3, 9)),
    ("conv2dT", lambda nn: nn.Conv2DTranspose(4, 2, strides=2),
     (2, 3, 5, 5)),
    ("maxpool", lambda nn: nn.MaxPool2D(2), (2, 3, 8, 8)),
    ("avgpool", lambda nn: nn.AvgPool2D(2), (2, 3, 8, 8)),
    ("gap", lambda nn: nn.GlobalAvgPool2D(), (2, 3, 6, 6)),
    ("batchnorm", lambda nn: nn.BatchNorm(), (4, 3, 5)),
    ("layernorm", lambda nn: nn.LayerNorm(), (4, 6)),
    ("instancenorm", lambda nn: nn.InstanceNorm(), (3, 4, 6)),
    ("dropout_eval", lambda nn: nn.Dropout(0.5), (4, 6)),
    ("embedding", lambda nn: nn.Embedding(20, 5), (3, 4)),
    ("leakyrelu", lambda nn: nn.LeakyReLU(0.1), (3, 5)),
    ("prelu", lambda nn: nn.PReLU(), (3, 5)),
    ("elu", lambda nn: nn.ELU(), (3, 5)),
    ("swish", lambda nn: nn.Swish(), (3, 5)),
    ("flatten", lambda nn: nn.Flatten(), (2, 3, 4)),
]
NO_GRAD = ("dropout_eval", "embedding")


def _input(name, shape, seed):
    rng = np.random.RandomState(seed)
    if name == "embedding":          # indices in range (floats, as gluon)
        return rng.randint(0, 20, shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


def _pair(name, layer_fn, shape, seed=0):
    """(JAX layer, port layer with its weights, numpy input)."""
    x = _input(name, shape, seed)
    jmx.random.seed(seed)
    jnet = layer_fn(jnn)
    jnet.initialize()
    with jag.pause():
        jnet(jnd.array(x))
    arrays = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    tnet = layer_fn(tnn)
    tnet.initialize(device="cpu")
    with tag.pause():
        tnet(torch.from_numpy(x))
    load_gluon_params(tnet, arrays)
    return jnet, tnet, x


@pytest.mark.parametrize("name,layer_fn,shape", CASES,
                         ids=[c[0] for c in CASES])
def test_hybridize_matches_jax(name, layer_fn, shape):
    jnet, tnet, x = _pair(name, layer_fn, shape)
    with tag.pause():
        eager = tnet(torch.from_numpy(x)).numpy()
    tnet.hybridize()
    jnet.hybridize()
    with tag.pause():
        hybrid1 = tnet(torch.from_numpy(x)).numpy()
        hybrid2 = tnet(torch.from_numpy(x)).numpy()   # same signature
    with jag.pause():
        want = jnet(jnd.array(x)).asnumpy()
    assert (hybrid1 == eager).all() and (hybrid2 == eager).all()
    assert tnet._cached_op.signatures == 1
    np.testing.assert_allclose(hybrid1, want, **FWD_TOL)
    np.testing.assert_allclose(hybrid2, want, **FWD_TOL)


@pytest.mark.parametrize("name,layer_fn,shape",
                         [c for c in CASES if c[0] not in NO_GRAD],
                         ids=[c[0] for c in CASES if c[0] not in NO_GRAD])
def test_hybridize_gradients_match_jax(name, layer_fn, shape):
    jnet, tnet, x = _pair(name, layer_fn, shape, seed=1)
    tnet.hybridize()
    jnet.hybridize()
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    with tag.record():
        loss = (tnet(xt) ** 2).sum()
    tag.backward(loss)
    xj = jnd.array(x)
    xj.attach_grad()
    with jag.record():
        jloss = (jnet(xj) ** 2).sum()
    jloss.backward()
    np.testing.assert_allclose(xt.grad.numpy(), xj.grad.asnumpy(),
                               **GRAD_TOL)


def _mlp(prefix):
    net = tnn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(tnn.Dense(8, activation="relu"), tnn.BatchNorm(),
                tnn.Dense(3))
    net.initialize(device="cpu",
                   generator=torch.Generator().manual_seed(0))
    with tag.pause():
        net(torch.zeros(2, 5))
    return net


def test_cached_op_keys_and_errors():
    """One signature per (training, recording, structure, opaque
    arguments, shapes and dtypes); a repeated call adds none; children
    of a hybridized block run inside its call; a non-hashable non-array
    argument raises the reference's TypeError."""
    net = _mlp("hk_")
    net.hybridize()
    x = torch.randn(4, 5)
    with tag.pause():
        net(x)
        net(x)
    op = net._cached_op
    assert op.signatures == 1
    with tag.pause():
        net(torch.randn(6, 5))                  # new shape
    with tag.record():
        net(x)                                   # training, recording
    with tag.pause():
        net(x.double().float())                  # same as the first
    assert op.signatures == 3
    for child in net._children_blocks():
        assert child._active and child._cached_op is None

    class TakesOpaque(tnn.HybridBlock):
        def hybrid_forward(self, F, x, scale):
            return x * (scale["s"] if isinstance(scale, dict) else scale[0])
    blk = TakesOpaque()
    blk.hybridize()
    with pytest.raises(TypeError, match="hashable"):
        blk(x, {"s": 2.0})
    assert (blk(x, [2.0]) == x * 2.0).all()
    assert blk._cached_op.signatures == 1


def test_invalidation_cast_reload_reinit():
    """``cast``, ``hybridize()`` again, ``initialize(force_reinit=True)``
    and ``reset_ctx`` drop the cached op; reloaded weights are what the
    next hybridized call computes with; the output matches the JAX
    hybridized net holding the same weights."""
    jmx.random.seed(2)
    jnet = jnn.HybridSequential(prefix="hinv_")
    with jnet.name_scope():
        jnet.add(jnn.Dense(8, activation="relu"), jnn.Dense(3))
    jnet.initialize()
    x = np.random.RandomState(3).randn(4, 5).astype(np.float32)
    with jag.pause():
        jnet(jnd.array(x))
    jnet.hybridize()
    net = tnn.HybridSequential(prefix="hinv_")
    with net.name_scope():
        net.add(tnn.Dense(8, activation="relu"), tnn.Dense(3))
    net.initialize(device="cpu")
    with tag.pause():
        net(torch.from_numpy(x))
    load_gluon_params(net, {k: p.data().asnumpy() for k, p in
                            jnet.collect_params().items()})
    net.hybridize()
    with tag.pause():
        first = net(torch.from_numpy(x)).numpy()
    with jag.pause():
        np.testing.assert_allclose(first, jnet(jnd.array(x)).asnumpy(),
                                   **FWD_TOL)
    op = net._cached_op
    with tempfile.TemporaryDirectory() as tmp:
        # reload new weights (in place: the cached op stays)
        path = os.path.join(tmp, "w.params")
        rng = np.random.RandomState(4)
        for p in net.collect_params().values():
            p.set_data(torch.from_numpy(
                rng.randn(*p.shape).astype(np.float32)))
        net.save_parameters(path)
        jnet.load_parameters(path)
        for p in net.collect_params().values():
            p.set_data(torch.zeros(p.shape))
        net.load_parameters(path)
        assert net._cached_op is op
        with tag.pause():
            second = net(torch.from_numpy(x)).numpy()
        with jag.pause():
            np.testing.assert_allclose(
                second, jnet(jnd.array(x)).asnumpy(), **FWD_TOL)
        assert not np.allclose(first, second)
    net.cast("float64")
    assert net._cached_op is None
    with tag.pause():
        out64 = net(torch.from_numpy(x).double())
    assert out64.dtype == torch.float64
    op = net._cached_op
    net.hybridize()
    assert net._cached_op is None
    with tag.pause():
        net(torch.from_numpy(x).double())
    net.initialize(force_reinit=True)
    assert net._cached_op is None
    with tag.pause():
        reinit = net(torch.from_numpy(x).double()).numpy()
    assert not np.allclose(reinit, out64.numpy())
    net.reset_ctx("cpu")
    assert net._cached_op is None
    del op


def test_hybridize_inactive_and_deferred():
    """``hybridize(active=False)`` goes back to the plain call; a block
    whose shapes are still deferred resolves them in the cached op's
    first call (predict mode: the running statistics stay)."""
    net = tnn.HybridSequential(prefix="hdef_")
    with net.name_scope():
        net.add(tnn.Dense(4), tnn.BatchNorm())
    net.initialize(device="cpu")
    net.hybridize()
    x = torch.randn(3, 7)
    with tag.train_mode():
        out = net(x)
    assert out.shape == (3, 4)
    bn = net[1]
    assert bn.running_mean.data().abs().sum() > 0   # one training call
    net.hybridize(active=False)
    assert net._cached_op is None
    with tag.pause():
        net(x)
    assert net._cached_op is None

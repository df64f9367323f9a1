"""PyTorch port, the vision model zoo: every ``get_model`` constructor of
the JAX package builds in the port, and its eval forward matches the
JAX net's on the same weights (batch 1, ``classes=10``).

The weights travel the file route: the port's net is initialized
(Xavier, a seeded generator; BatchNorm's gamma, beta and running
statistics drawn at random too, so the eval-mode normalisation is not
the identity), run once to resolve its deferred shapes, and saved with
``save_parameters``; the JAX net, never initialized, takes them through
its ``load_parameters`` (which materialises every deferred shape from
the file) and runs hybridized (one XLA program: its eager first call
compiles op by op, 20-55 s for a DenseNet).

Inputs are the smallest each architecture takes: 32x32 for ResNet, VGG
and MobileNet (the five stride-2 stages take 32 to 1x1; ResNet and
MobileNet also run below, on padding alone), 63 for AlexNet, 21 / 17
for SqueezeNet 1.0 / 1.1, 221 for DenseNet (its final 7x7 average
pool), 299 for Inception V3 (its final 8x8 average pool).

Tolerance: max |port - JAX| <= 2e-4 x max |JAX| — f32 convolutions
summed in different orders (oneDNN's against XLA's), compounded over up
to 152 layers of a net whose random weights grow or shrink the
activations; the families are split across
``tests/test_torch_vision_zoo*.py`` to keep each file short.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

torch.set_num_threads(2)

ZOO_REL_TOL = 2e-4

SIZES = {"resnet": 32, "vgg": 32, "mobilenet": 32, "alexnet": 63,
         "squeezenet1_0": 21, "squeezenet1_1": 17, "densenet": 221,
         "inception": 299}


def size_of(name):
    for key in sorted(SIZES, key=len, reverse=True):
        if name.startswith(key):
            return SIZES[key]
    raise KeyError(name)


def constructors(prefix):
    """The ``get_model`` names of one family (the JAX package's list)."""
    return sorted(n for n in jvision._models
                  if n.startswith(prefix) and not n.startswith("get_"))


def port_net(name, seed=0, **kw):
    """The port's ``name`` on the CPU: Xavier weights, random BatchNorm
    parameters and statistics, its deferred shapes resolved."""
    net = tvision.get_model(name, classes=10, prefix=f"{name}_", **kw)
    gen = torch.Generator().manual_seed(seed)
    net.initialize(tmx.initializer.Xavier(), device="cpu", generator=gen)
    x = torch.zeros((1, 3) + (size_of(name),) * 2)
    with tmx.autograd.pause():
        net(x)
    with torch.no_grad():
        for pname, p in net.collect_params().items():
            d = p.data()
            if pname.endswith(("gamma", "running_var")):
                d.copy_(0.5 + torch.rand(d.shape, generator=gen))
            elif pname.endswith(("beta", "running_mean")):
                d.copy_(0.1 * torch.randn(d.shape, generator=gen))
    return net


def check_model(name):
    size = size_of(name)
    x = np.random.RandomState(1).randn(1, 3, size, size).astype(np.float32)
    net = port_net(name)
    with tmx.autograd.pause():
        got = net(torch.from_numpy(x)).detach().numpy()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"{name}.params")
        net.save_parameters(path)
        ref = jvision.get_model(name, classes=10, prefix=f"{name}_")
        ref.load_parameters(path)
    ref.hybridize()
    import mxnet_tpu as mx
    want = ref(mx.nd.array(x)).asnumpy()
    assert got.shape == want.shape == (1, 10)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= ZOO_REL_TOL * np.abs(want).max(), (name, err,
                                                     np.abs(want).max())


def test_every_jax_constructor_builds_in_the_port():
    jnames = sorted(n for n in jvision._models if not n.startswith("get_"))
    tnames = sorted(n for n in tvision._models if not n.startswith("get_"))
    assert tnames == jnames and len(jnames) == 34
    with pytest.raises(ValueError):
        tvision.get_model("resnet19_v1")


@pytest.mark.parametrize("name", [n for n in constructors("resnet")
                                  if n.endswith("_v1")])
def test_resnet_v1_eval_forward_matches_jax(name):
    check_model(name)

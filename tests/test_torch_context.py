"""PyTorch port, ``mx.cpu()`` / ``mx.gpu()`` and ``NDArray.context``
against the JAX package's ``Context`` (``mxnet_tpu/context.py``): the
names at the package root, equality and hashing by (type, id), the
reference's device-type codes, the ``with`` block's default device (and
the port's default outside one: the card, where the JAX package on a
host without an accelerator takes the CPU), and ``ctx=`` taking a
Context wherever the port takes a device."""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import context as tctx
from mxnet_tpu_torch import gluon, nd

torch.set_num_threads(2)

NAMES = ("Context", "cpu", "gpu", "tpu", "cpu_pinned", "current_context",
         "num_gpus", "num_tpus")


@pytest.mark.parametrize("name", NAMES)
def test_root_exports_the_context_names(name):
    assert hasattr(jmx, name)
    assert getattr(tmx, name) is getattr(tctx, name)


@pytest.mark.parametrize("kind", ["cpu", "gpu", "tpu", "cpu_pinned"])
def test_context_identity_matches_the_reference(kind):
    for i in (0, 1):
        j, t = getattr(jmx, kind)(i), getattr(tmx, kind)(i)
        assert (t.device_type, t.device_id) == (j.device_type, j.device_id)
        assert repr(t) == repr(j) == f"{kind}({i})"
        assert t == tmx.Context(kind, i) and t != tmx.Context(kind, 1 - i)
        assert hash(t) == hash(tmx.Context(kind, i))
        assert tmx.Context(t) == t
    assert tmx.Context.devtype2mask == jmx.Context.devtype2mask
    assert tmx.Context.devmask2type == jmx.Context.devmask2type
    with pytest.raises(ValueError):
        tmx.Context("npu")


def test_torch_devices_of_contexts():
    assert tmx.cpu().torch_device == torch.device("cpu")
    assert tmx.cpu_pinned(3).torch_device == torch.device("cpu")
    assert tmx.gpu(1).torch_device == torch.device("cuda", 1)
    assert tmx.tpu(0).torch_device == torch.device("cuda", 0)
    assert tctx.device("cpu") == tmx.cpu(0)
    assert tctx.device(torch.device("cuda", 2)) == tmx.gpu(2)
    assert len({tmx.cpu(), tmx.cpu(0), tmx.gpu(0), tmx.tpu(0)}) == 3


def test_with_block_sets_the_default_device_as_the_reference():
    assert jmx.current_context() == jmx.cpu(0)     # a CPU-only host
    assert tmx.current_context() == tmx.gpu(0)     # the port: the card
    for pkg in (jmx, tmx):
        with pkg.gpu(1):
            assert pkg.current_context() == pkg.gpu(1)
            with pkg.cpu() as c:
                assert c == pkg.cpu(0)
                assert pkg.current_context() == pkg.cpu(0)
            assert pkg.current_context() == pkg.gpu(1)
    seen = []
    with tmx.cpu():
        t = threading.Thread(target=lambda: seen.append(
            tmx.current_context()))
        t.start()
        t.join()
    assert seen == [tmx.gpu(0)]       # a with block is its thread's


def test_ndarray_context_is_a_context_equal_to_the_reference():
    """The test the port failed before: ``NDArray.context`` was a
    ``torch.device`` and ``mx.cpu`` did not exist."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    j = jmx.nd.array(x, ctx=jmx.cpu())
    t = nd.array(x, ctx=tmx.cpu())
    assert isinstance(t.context, tmx.Context)
    assert t.context == tmx.cpu() and t.ctx == t.context
    assert (t.context.device_type, t.context.device_id) == \
        (j.context.device_type, j.context.device_id)
    assert repr(t).endswith("@cpu(0)>") and repr(j).endswith("@cpu(0)>")
    assert t.as_in_context(tmx.cpu()) is t
    assert t.copyto(tmx.cpu()).context == tmx.cpu()


def test_ctx_takes_a_context_everywhere_and_the_card_by_default():
    with tmx.cpu():
        assert nd.zeros((2,)).context == tmx.cpu()
        assert nd.random.uniform(shape=(2,)).context == tmx.cpu()
        net = gluon.nn.Dense(3, in_units=2, prefix="ctxd_")
        net.initialize()
        assert net.weight.data().device == torch.device("cpu")
    assert nd.ones((2,), ctx=tmx.cpu_pinned()).context == tmx.cpu()
    net = gluon.nn.Dense(3, in_units=2, prefix="ctxe_")
    net.initialize(ctx=tmx.cpu())
    assert net.weight.data().device == torch.device("cpu")
    out = net(nd.ones((1, 2), ctx=tmx.cpu()))
    assert out.device == torch.device("cpu")
    if not torch.cuda.is_available():
        for make in (lambda: nd.zeros((2,)),
                     lambda: nd.zeros((2,), ctx=tmx.gpu(0)),
                     lambda: nd.array([1.0], ctx=tmx.tpu()),
                     lambda: gluon.nn.Dense(2, in_units=2).initialize()):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    assert tmx.num_gpus() == tmx.num_tpus() == torch.cuda.device_count()
    assert tmx.cpu().memory_info() == (None, None)

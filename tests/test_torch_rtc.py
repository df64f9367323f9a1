"""PyTorch port, ``rtc``: a user's kernel registered as an op. The three
ops of tests/test_rtc.py are registered in both packages: in the JAX
package with their Pallas bodies (interpret mode on the CPU), in the
port with CUDA C sources (``chip_smoke.RTC_SOURCES``, the script's own
kernels) and ``reference_fn``, which the port runs on CPU tensors. The
CUDA kernels themselves run on the card in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.

Everything is held exactly except ``rowsum`` (``SUM_TOL = 1e-6``: five
f32 terms summed in another order).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.autograd as jag  # noqa: E402
from mxnet_tpu_torch import autograd as ag  # noqa: E402
from mxnet_tpu_torch import kernels, nd, rtc  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402

torch.set_num_threads(2)

SUM_TOL = 1e-6


def _pallas_bodies():
    def scale_add(x_ref, y_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0 + y_ref[...]

    def square(x_ref, o_ref):
        o_ref[...] = x_ref[...] * x_ref[...]

    def rowsum(x_ref, o_ref):
        o_ref[...] = jnp.sum(x_ref[...], axis=1)
    return {"scale_add": scale_add, "square": square, "rowsum": rowsum}


@pytest.fixture(scope="module")
def ops():
    """The three ops in both packages, as ``trtc_<kernel>``."""
    names, plain = chip_smoke.register_rtc_ops("trtc_")
    rows = lambda shapes, dtypes: ((shapes[0][0],), dtypes[0])  # noqa: E731
    for k, body in _pallas_bodies().items():
        kw = {}
        if k == "square":
            kw["reference_fn"] = lambda x: x * x
        if k == "rowsum":
            kw["out_shape"] = rows
        mx.rtc.register_pallas_op(names[k], body, **kw)
    # the port's CPU path runs reference_fn: give every op one here
    for k in ("scale_add", "rowsum"):
        kw = {"reference_fn": plain[k]}
        if k == "rowsum":
            kw.update(out_shape=rows, grid=lambda s: (s[0][0],), block=256)
        rtc.register_cuda_op(names[k], chip_smoke.RTC_SOURCES[k], k, **kw)
    yield names
    for n in names.values():
        treg._REGISTRY.pop(n, None)


def test_outputs_agree_with_the_pallas_ops(ops):
    rng = np.random.RandomState(0)
    a = rng.randn(3, 5).astype(np.float32)
    b = rng.randn(3, 5).astype(np.float32)
    before = kernels.launch_counts()
    got = getattr(nd, ops["scale_add"])(torch.from_numpy(a),
                                        torch.from_numpy(b))
    want = getattr(mx.nd, ops["scale_add"])(mx.nd.array(a), mx.nd.array(b))
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    got = getattr(nd, ops["square"])(torch.from_numpy(a))
    want = getattr(mx.nd, ops["square"])(mx.nd.array(a))
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    got = getattr(nd, ops["rowsum"])(torch.from_numpy(a))
    want = getattr(mx.nd, ops["rowsum"])(mx.nd.array(a))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), atol=SUM_TOL,
                               rtol=0)
    assert kernels.launch_counts() == before


def test_square_gradient_under_record_agrees(ops):
    x = np.array([1.0, 2.0, 3.0], np.float32)
    jx = mx.nd.array(x)
    jx.attach_grad()
    with jag.record():
        jy = getattr(mx.nd, ops["square"])(jx).sum()
    jy.backward()
    tx = torch.from_numpy(x).requires_grad_()
    with ag.record():
        ty = getattr(nd, ops["square"])(tx).sum()
    ty.backward()
    np.testing.assert_array_equal(tx.grad.numpy(), jx.grad.asnumpy())
    assert treg.get(ops["square"]).differentiable


def test_kernel_function_backward_is_the_reference_vjp():
    """The autograd Function around a kernel (its forward stood in for by
    the plain function, as no kernel runs here) takes its gradient from
    ``reference_fn``'s vjp."""
    f = rtc._with_vjp(lambda x, y: x * y + 1.0, lambda x, y: x * y)
    x = torch.tensor([1.0, -2.0, 3.0], requires_grad=True)
    y = torch.tensor([4.0, 5.0, 6.0], requires_grad=True)
    out = f(x, y)
    assert torch.equal(out.detach(), x.detach() * y.detach() + 1.0)
    out.backward(torch.tensor([1.0, 2.0, 3.0]))
    assert torch.equal(x.grad, torch.tensor([4.0, 10.0, 18.0]))
    assert torch.equal(y.grad, torch.tensor([1.0, -4.0, 9.0]))


def test_cpu_call_without_reference_fn_raises():
    name = "trtc_no_reference"
    try:
        rtc.register_cuda_op(name, chip_smoke.RTC_SOURCES["square"],
                             "square")
        assert not treg.get(name).differentiable
        with pytest.raises(RuntimeError, match="reference_fn"):
            getattr(nd, name)(torch.ones(3))
    finally:
        treg._REGISTRY.pop(name, None)


def test_launch_dimensions():
    shapes = [(10, 300)]
    assert rtc._dims(None, shapes, 12) == (12, 1, 1)
    assert rtc._dims((4, 2), shapes, 1) == (4, 2, 1)
    assert rtc._dims(lambda s: (s[0][0],), shapes, 1) == (10, 1, 1)
    for bad in ((), (1, 1, 1, 1), (0,)):
        with pytest.raises(ValueError):
            rtc._dims(bad, shapes, 1)
    with pytest.raises(ValueError, match="identifier"):
        kernels.rtc_library("", "not a name")


def test_cuda_module_and_pallas_registration_point_to_register_cuda_op():
    with pytest.raises(NotImplementedError, match="register_cuda_op"):
        rtc.CudaModule("__global__ void k() {}")
    with pytest.raises(NotImplementedError, match="register_cuda_op"):
        rtc.register_pallas_op("p", lambda x_ref, o_ref: None)

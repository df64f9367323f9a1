"""PyTorch port, ``_adamw_update``'s rescale array (``rescale_grad_arr``,
the op's fifth input): the port's op against the JAX op on the same
numpy inputs, on the CPU, and the launch row that carries the array to
the card's kernel.

The array replaces the float ``rescale_grad``; ``grad * rs`` is one f32
product on both sides. Tolerance ``OPT_TOL = 1e-6``, as
``tests/test_torch_optimizer.py`` states (the same elementwise update;
only the last bit of an operation may differ). The kernel is held
against the twin bit for bit on the card (``tests/test_torch_cuda.py``).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import mxnet_tpu as mx  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu_torch import nd as tnd  # noqa: E402
from mxnet_tpu_torch.ops import optimizer_ops as tops  # noqa: E402

torch.set_num_threads(2)

OPT_TOL = 1e-6
KW = dict(lr=0.05, wd=0.01, eta=0.9, beta1=0.8, clip_gradient=0.7)


def _inputs(seed, shape=(4, 6)):
    rng = np.random.RandomState(seed)
    w, g, m = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    v = rng.uniform(0.1, 1.0, shape).astype(np.float32)
    return [w, g, m, v]


@pytest.mark.parametrize("rescale", ["array", "none", "float"])
def test_adamw_rescale_array_matches_the_jax_op(rescale):
    """``nd._adamw_update(w, g, m, v, r)`` with a one-element ``r``, with
    ``r=None`` (the float ``rescale_grad`` applies) and with only the
    float: three updates, each written in place, against the JAX op."""
    arrays = _inputs(3)
    kw = dict(KW, rescale_grad=0.25)
    jx = [mx.nd.array(a) for a in arrays]
    tx = [torch.from_numpy(a.copy()) for a in arrays]
    for step in range(3):
        r = np.array([0.5 + 0.25 * step], np.float32)
        jr = {"array": mx.nd.array(r), "none": None}.get(rescale)
        tr = {"array": torch.from_numpy(r), "none": None}.get(rescale)
        jargs = jx + ([jr] if rescale != "float" else [])
        targs = tx + ([tr] if rescale != "float" else [])
        want = mx.nd._adamw_update(*jargs, **kw)
        for a, b in zip(jx[:1] + jx[2:], want):
            a[:] = b
        got = tnd._adamw_update(*targs, **kw)
        assert [id(x) for x in got] == [id(tx[i]) for i in (0, 2, 3)]
    for j, t in zip(jx, tx):
        np.testing.assert_allclose(t.numpy(), j.asnumpy(), rtol=OPT_TOL,
                                   atol=OPT_TOL)


def test_rescale_array_differs_from_the_float():
    """The array, not the float, scales the gradient: an array of 0.5
    with ``rescale_grad=4.0`` gives the update of the float 0.5."""
    arrays = _inputs(4)
    a = [torch.from_numpy(x.copy()) for x in arrays]
    b = [torch.from_numpy(x.copy()) for x in arrays]
    tnd._adamw_update(*a, torch.tensor([0.5]), rescale_grad=4.0, **KW)
    tnd._adamw_update(*b, rescale_grad=0.5, **KW)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_rescale_array_rides_the_launch_row():
    """The kernel's row: the array's address in int64 word
    ``RESCALE_WORD`` (floats 10-11, past the rule's ten scalars), 0
    without one, the gradient's in the last word; the float
    ``rescale_grad`` stays in float 8."""
    g, r = torch.ones(3), torch.tensor([0.5])
    rows = tops.scalar_rows("_adamw_update",
                            [dict(rescale_grad_arr=r, rescale_grad=2.0),
                             dict(rescale_grad=2.0)], [g, g])
    words = rows.view(np.int64)
    assert tops.RESCALE_WORD * 2 >= len(tops.RULES["_adamw_update"].scalars(
        {}))
    assert words[0, tops.RESCALE_WORD] == r.data_ptr()
    assert words[1, tops.RESCALE_WORD] == 0
    assert words[0, -1] == words[1, -1] == g.data_ptr()
    assert rows[0, 8] == rows[1, 8] == np.float32(2.0)

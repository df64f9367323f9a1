"""PyTorch port, flash attention: the port's op (on the CPU its kernels'
plain twins) against the JAX package's ``flash_attention`` (Pallas in
interpret mode) and ``attention_reference``, on the same numpy inputs.

Tolerances, each with its reason:

- ``OUT_TOL = 1e-5`` — forward output and logsumexp: the same f32 math,
  one softmax here against the kernel's online softmax over blocks;
  outputs and lse are O(1).
- ``GRAD_TOL = 2e-5`` — dq/dk/dv/dbias: sums over up to 40 queries or keys
  of O(1) products in another order (JAX's own kernel-vs-reference test
  allows 1e-4).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu.ops import flash_attention as jfa  # noqa: E402
from mxnet_tpu_torch import kernels  # noqa: E402
from mxnet_tpu_torch.ops import flash_attention as tfa  # noqa: E402

torch.set_num_threads(2)

OUT_TOL = 1e-5
GRAD_TOL = 2e-5
B, H, D = 2, 2, 16


def _case(seed, tq, tk, with_bias, lengths=None, d=D):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, tq, d).astype(np.float32)
    k = rng.randn(B, H, tk, d).astype(np.float32)
    v = rng.randn(B, H, tk, d).astype(np.float32)
    g = rng.randn(B, H, tq, d).astype(np.float32)
    bias = None
    if with_bias:
        lengths = lengths if lengths is not None else (tk, max(1, tk // 3))
        bias = np.where(np.arange(tk)[None, :] < np.asarray(lengths)[:, None],
                        0.0, -1e30).astype(np.float32)
    return q, k, v, g, bias


def _jax(q, k, v, g, bias, causal):
    """JAX flash forward (out, lse) and its VJP (dq, dk, dv[, dbias])."""
    args = [jnp.asarray(a) for a in (q, k, v)]
    if bias is not None:
        args.append(jnp.asarray(bias))

    def f(*a):
        return jfa.flash_attention(*a[:3], bias=a[3] if len(a) > 3 else None,
                                   causal=causal)
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(g))
    tq, tk = q.shape[2], k.shape[2]
    _, lse = jfa._flash_forward(
        args[0], args[1], args[2], args[3] if bias is not None else None,
        causal, None, min(jfa.DEFAULT_BLOCK_Q, max(tq, 8)),
        min(jfa.DEFAULT_BLOCK_K, max(tk, 8)), True, want_lse=True)
    lse = np.asarray(lse)[:, :tq, 0]
    return np.asarray(out), lse, [np.asarray(x) for x in grads]


def _port(q, k, v, g, bias, causal, flash=True):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tb = None
    if bias is not None:
        tb = torch.from_numpy(bias).requires_grad_()
    out = tfa.scaled_dot_product_attention(*ts, tb, causal=causal,
                                           flash=flash)
    out.backward(torch.from_numpy(g))
    grads = [t.grad.numpy() for t in ts]
    if tb is not None:
        grads.append(tb.grad.numpy())
    return out.detach().numpy(), grads


def _close(a, b, tol, what):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("tq,tk,with_bias,causal", [
    (16, 16, False, False),
    (13, 13, True, True),     # not a multiple of 8
    (20, 36, True, False),    # Tq != Tk
    (20, 36, True, True),
    (36, 20, False, True),
])
def test_flash_matches_jax_flash_forward_lse_and_grads(tq, tk, with_bias,
                                                       causal):
    q, k, v, g, bias = _case(tq * 100 + tk, tq, tk, with_bias)
    j_out, j_lse, j_grads = _jax(q, k, v, g, bias, causal)
    t_out, t_grads = _port(q, k, v, g, bias, causal)
    _close(t_out, j_out, OUT_TOL, "out")
    tb = None if bias is None else torch.from_numpy(bias)
    _, t_lse = tfa.flash_forward(*(torch.from_numpy(a) for a in (q, k, v)),
                                 tb, causal, None)
    _close(t_lse.numpy(), j_lse, OUT_TOL, "lse")
    assert len(t_grads) == len(j_grads)
    for a, b, name in zip(t_grads, j_grads, ["dq", "dk", "dv", "dbias"]):
        _close(a, b, GRAD_TOL, name)


@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax_flash_at_wide_head_dims(d, causal):
    """Head dims above 128, which the card's kernels take at 256 (160
    zero-padded to it): the port's op against JAX's flash kernel on the
    same inputs, forward, lse and every gradient."""
    q, k, v, g, bias = _case(d + int(causal), 12, 20, True, d=d)
    j_out, j_lse, j_grads = _jax(q, k, v, g, bias, causal)
    t_out, t_grads = _port(q, k, v, g, bias, causal)
    _close(t_out, j_out, OUT_TOL, "out")
    _, t_lse = tfa.flash_forward(*(torch.from_numpy(a) for a in (q, k, v)),
                                 torch.from_numpy(bias), causal, None)
    _close(t_lse.numpy(), j_lse, OUT_TOL, "lse")
    assert tfa.kernel_head_dim(d) == 256
    for a, b, name in zip(t_grads, j_grads, ["dq", "dk", "dv", "dbias"]):
        _close(a, b, GRAD_TOL, name)


def test_fully_masked_row_matches_jax_flash():
    """Batch row 1's bias masks every key: JAX's kernel gives the mean of
    v over the keys (every score is -1e30, so all weigh the same) and
    the backward of that; the port returns the same."""
    q, k, v, g, bias = _case(7, 12, 12, True, lengths=(9, 0))
    j_out, j_lse, j_grads = _jax(q, k, v, g, bias, False)
    t_out, t_grads = _port(q, k, v, g, bias, False)
    _close(t_out, j_out, OUT_TOL, "out")
    np.testing.assert_allclose(t_out[1], np.broadcast_to(
        v[1].mean(axis=1, keepdims=True), t_out[1].shape), rtol=1e-5,
        atol=1e-5)
    assert np.isfinite(t_out).all()
    for a, b, name in zip(t_grads, j_grads, ["dq", "dk", "dv", "dbias"]):
        _close(a, b, GRAD_TOL, name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_false_is_attention_reference(causal):
    """With Tq != Tk the two causal masks differ: the flash path masks
    absolute positions (row >= col), ``attention_reference`` is end
    aligned (tril(k=Tk-Tq)). The port keeps both, as the JAX package."""
    q, k, v, g, bias = _case(11, 10, 24, True)
    jq, jk, jv, jb = (jnp.asarray(a) for a in (q, k, v, bias))
    j_ref, ref_vjp = jax.vjp(
        lambda *a: jfa.attention_reference(*a, causal=causal), jq, jk, jv,
        jb)
    t_ref, t_grads = _port(q, k, v, g, bias, causal, flash=False)
    _close(t_ref, np.asarray(j_ref), OUT_TOL, "out")
    for a, b, name in zip(t_grads, ref_vjp(jnp.asarray(g)),
                          ["dq", "dk", "dv", "dbias"]):
        _close(a, b, GRAD_TOL, name)
    t_flash, _ = _port(q, k, v, g, bias, causal, flash=True)
    j_flash = np.asarray(jfa.flash_attention(jq, jk, jv, bias=jb,
                                             causal=causal))
    _close(t_flash, j_flash, OUT_TOL, "flash out")
    if causal:
        assert np.abs(t_flash - t_ref).max() > 0.1
    else:
        _close(t_flash, t_ref, OUT_TOL, "flash vs reference")


def test_backward_twin_splits_into_the_kernels_twins():
    """``flash_backward`` (the kernel wrappers, on the CPU their twins)
    equals ``flash_backward_reference``; the bias gradient is skipped
    when not wanted, and no kernel launch is counted on the CPU."""
    q, k, v, g, bias = _case(3, 20, 28, True)
    tq, tk, tv, tg, tb = (torch.from_numpy(a) for a in (q, k, v, g, bias))
    before = kernels.launch_counts()
    out, lse = tfa.flash_forward(tq, tk, tv, tb, True, None)
    ref = tfa.flash_backward_reference(tq, tk, tv, tb, out, lse, tg, True,
                                       0.25)
    got = tfa.flash_backward(tq, tk, tv, tb, out, lse, tg, True, None)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert tfa.flash_backward(tq, tk, tv, tb, out, lse, tg, True, None,
                              want_dbias=False)[3] is None
    assert kernels.launch_counts() == before

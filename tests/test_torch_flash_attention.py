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
- ``LP_TOL`` — bf16 ``2e-2``, f16 ``5e-3``, relative to the largest
  magnitude of each result: the 16-bit twins against JAX's kernels on
  16-bit inputs. Both round P, P^T, dS^T and the outputs to the input
  dtype from f32 sums taken in another order, so a value on a rounding
  boundary lands one ulp apart (bf16: 2^-8 relative, f16: 2^-11), and
  delta carries that into dS. lse stays f32 (``OUT_TOL``).
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
LP_TOL = {"bfloat16": 2e-2, "float16": 5e-3}
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


def _lp_rel(got, want):
    """max |got - want| over max(1, max |want|), both widened to f32."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(1.0,
                                                  float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("d,tq,tk,with_bias,causal", [
    (64, 16, 16, False, False),
    (64, 20, 36, True, False),   # Tq != Tk, padding bias
    (64, 13, 13, False, True),   # causal, not a multiple of 8
    (64, 20, 36, True, True),
    (256, 12, 20, True, False),
    (256, 12, 20, False, True),
])
def test_flash_16bit_twins_match_jax_flash(dtype, d, tq, tk, with_bias,
                                           causal):
    """bf16 and f16 q, k, v, dout (and a bias in the same dtype, as AMP
    casts the mask): the port's op (its kernels' twins) against JAX's
    flash kernels in interpret mode on the same 16-bit inputs. out, dq,
    dk, dv and dbias come back in the input dtype, lse in f32; the
    twins round P and dS where the TPU kernels do."""
    q, k, v, g, bias = _case(d * 7 + tq + int(causal), tq, tk, with_bias,
                             d=d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)]
    if bias is not None:
        jargs.append(jnp.asarray(bias, jdt))

    def f(*a):
        return jfa.flash_attention(*a[:3], bias=a[3] if len(a) > 3 else None,
                                   causal=causal)
    j_out, vjp = jax.vjp(f, *jargs)
    j_grads = vjp(jnp.asarray(g, jdt))
    _, j_lse = jfa._flash_forward(
        *jargs[:3], jargs[3] if bias is not None else None, causal, None,
        min(jfa.DEFAULT_BLOCK_Q, max(tq, 8)),
        min(jfa.DEFAULT_BLOCK_K, max(tk, 8)), True, want_lse=True)

    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    tb = (None if bias is None
          else torch.from_numpy(bias).to(tdt).requires_grad_())
    t_out = tfa.scaled_dot_product_attention(*ts, tb, causal=causal)
    t_out.backward(torch.from_numpy(g).to(tdt))
    _, t_lse = tfa.flash_forward(*(t.detach() for t in ts),
                                 None if tb is None else tb.detach(),
                                 causal, None)
    t_grads = [t.grad for t in ts] + ([] if tb is None else [tb.grad])
    assert t_out.dtype == tdt and t_lse.dtype == torch.float32
    assert all(t.dtype == tdt for t in t_grads)
    tol = LP_TOL[dtype]
    assert _lp_rel(t_out.detach().float(), j_out.astype(jnp.float32)) \
        < tol, "out"
    _close(t_lse.numpy(), np.asarray(j_lse)[:, :tq, 0], OUT_TOL, "lse")
    assert len(t_grads) == len(j_grads)
    for a, b, name in zip(t_grads, j_grads, ["dq", "dk", "dv", "dbias"]):
        assert _lp_rel(a.float(), b.astype(jnp.float32)) < tol, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_16bit_twins_round_p_and_ds_where_the_kernels_do(dtype):
    """The 16-bit twins equal an f32 computation whose P, P^T and dS are
    rounded to the input dtype at the product (and only there), and
    differ from the unrounded one; f32 inputs round nothing."""
    q, k, v, g, bias = _case(5, 20, 36, True, d=64)
    tq, tk, tv, tg = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    tb = torch.from_numpy(bias)
    scale = 0.125
    out, lse = tfa.flash_forward_reference(tq, tk, tv, tb, False, scale)
    s = torch.einsum("bhqd,bhkd->bhqk", tq.float(), tk.float()) * scale \
        + tb[:, None, None, :]
    p = torch.exp(s - lse.reshape(B, H, 20, 1))
    lp = lambda x: x.to(dtype).float()     # noqa: E731
    m = s.amax(-1, keepdim=True)
    pe = torch.exp(s - m)
    want = (torch.einsum("bhqk,bhkd->bhqd", lp(pe), tv.float())
            / pe.sum(-1, keepdim=True)).to(dtype)
    assert torch.equal(out, want)
    unrounded = (torch.einsum("bhqk,bhkd->bhqd", pe, tv.float())
                 / pe.sum(-1, keepdim=True)).to(dtype)
    assert not torch.equal(out, unrounded)
    delta = (tg.float() * out.float()).sum(-1).reshape(B * H, 20)
    dk, dv, _ = tfa.flash_bwd_dkv_reference(tq, tk, tv, tb, tg, lse, delta,
                                            False, scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", tg.float(), tv.float())
    ds = p * (dp - delta.reshape(B, H, 20, 1))
    assert torch.equal(dv, torch.einsum("bhqk,bhqd->bhkd", lp(p),
                                        tg.float()).to(dtype))
    assert torch.equal(dk, (scale * torch.einsum(
        "bhqk,bhqd->bhkd", lp(ds), tq.float())).to(dtype))
    dq = tfa.flash_bwd_dq_reference(tq, tk, tv, tb, tg, lse, delta, False,
                                    scale)
    assert torch.equal(dq, (scale * torch.einsum(
        "bhqk,bhkd->bhqd", lp(ds), tk.float())).to(dtype))

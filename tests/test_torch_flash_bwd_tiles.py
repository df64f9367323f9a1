"""PyTorch port, the 16-bit flash backward kernels' arithmetic on the CPU.

``csrc/flash_bwd_lp_sm90.cu`` (dK/dV/dbias and dQ on TMA and wgmma) runs
only on the card. This file emulates its arithmetic in torch, tile by
tile as the kernels walk their tiles, and holds the emulation against the
port's plain twins (``flash_bwd_dkv_reference``, ``flash_bwd_dq_reference``)
and against the JAX package's ``_flash_backward`` (Pallas in interpret
mode) on the same numpy inputs, in bf16 and f16:

- 64-row CTAs; streamed tiles of 64 rows, or 32 where the kernels stream
  32 (dK/dV at D >= 128, dQ at D = 256), zero-filled past T as TMA fills
  them;
- log2 units: ``2^((s * scale log2(e) + bias log2(e)) - lse log2(e))``;
  a query past Tq stages ``lse = +inf``, a key past Tk (dQ) a bias of
  ``-inf``;
- under causal, the tiles wholly above the diagonal skipped, the mask on
  the tiles it cuts;
- P^T and dS^T (dS) rounded to the input dtype before their products, the
  bias gradient from the unrounded dS^T.

Cases include a batch row whose every key is masked (valid length 0: its
lse is -1e30 + log(l), -1e30 in f32, and every key weighs 1) and Tq, Tk
that are not multiples of 64.

Tolerance ``LP_TOL`` (bf16 ``2e-2``, f16 ``5e-3`` of each result's largest
magnitude), the 16-bit flash tests' own: both sides round P^T, dS^T and
the outputs to the input dtype from f32 sums taken in another order, so
a value on a rounding boundary lands one ulp apart.
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
from mxnet_tpu_torch.ops import flash_attention as tfa  # noqa: E402

torch.set_num_threads(2)

LP_TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3}
LOG2E = 1.4426950408889634
M = 64   # rows a CTA owns: keys (dK/dV) or queries (dQ)


def stream_rows(D, kernel):
    """The streamed tile's rows: queries a dK/dV stage, keys a dQ stage."""
    if kernel == "dkv":
        return 32 if D >= 128 else 64
    return 32 if D == 256 else 64


def _pad_rows(x, n, value=0.0):
    """``x`` (BH, T, ...) padded along T to a multiple of ``n``."""
    pad = -x.shape[1] % n
    if pad == 0:
        return x
    shape = (x.shape[0], pad) + tuple(x.shape[2:])
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype)], 1)


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def emulate_dkv(q, k, v, bias, dout, lse, delta, causal, scale, skip=True):
    """The dK/dV kernel's arithmetic: ``(dk, dv, dbias (B*H, Tk))``; with
    ``skip=False`` every query tile is visited and, under causal,
    masked."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    n = stream_rows(D, "dkv")
    lp = q.dtype
    qf, gf = (_pad_rows(x.float().reshape(B * H, Tq, D), n)
              for x in (q, dout))
    kf, vf = (_pad_rows(x.float().reshape(B * H, Tk, D), M) for x in (k, v))
    lse2 = _pad_rows(lse * _f32(LOG2E), n, float("inf"))
    dl = _pad_rows(delta, n)
    bk = torch.zeros(B * H, kf.shape[1])
    if bias is not None:
        bk[:, :Tk] = bias.float().repeat_interleave(H, 0) * _f32(LOG2E)
    scale2 = _f32(scale) * _f32(LOG2E)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(kf)
    dbias = torch.zeros(B * H, kf.shape[1])
    for k0 in range(0, Tk, M):
        keys = slice(k0, k0 + M)
        key_pos = torch.arange(k0, k0 + M)[:, None]
        # causal: query tiles wholly before this key tile are skipped
        for q0 in range(k0 if causal and skip else 0, Tq, n):
            qs = slice(q0, q0 + n)
            st = kf[:, keys] @ qf[:, qs].transpose(1, 2)
            x = (st * scale2 + bk[:, keys, None]) - lse2[:, None, qs]
            if causal and (q0 < k0 + M - 1 or not skip):
                x = torch.where(torch.arange(q0, q0 + n)[None, :] < key_pos,
                                -float("inf"), x)
            p = torch.exp2(x)
            dpt = vf[:, keys] @ gf[:, qs].transpose(1, 2)
            dst = p * (dpt - dl[:, None, qs])
            dbias[:, keys] += dst.sum(2)
            dv[:, keys] += p.to(lp).float() @ gf[:, qs]
            dk[:, keys] += dst.to(lp).float() @ qf[:, qs]
    dk, dv = ((scale * dk)[:, :Tk], dv[:, :Tk])
    return (dk.reshape(B, H, Tk, D).to(lp), dv.reshape(B, H, Tk, D).to(lp),
            dbias[:, :Tk])


def emulate_dq(q, k, v, bias, dout, lse, delta, causal, scale, skip=True):
    """The dQ kernel's arithmetic; ``skip`` as in :func:`emulate_dkv`."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    n = stream_rows(D, "dq")
    lp = q.dtype
    qf, gf = (_pad_rows(x.float().reshape(B * H, Tq, D), M)
              for x in (q, dout))
    kf, vf = (_pad_rows(x.float().reshape(B * H, Tk, D), n) for x in (k, v))
    lse2 = _pad_rows(lse * _f32(LOG2E), M, float("inf"))
    dl = _pad_rows(delta, M)
    # the staged bias: -inf past Tk
    bs = torch.full((B * H, kf.shape[1]), -float("inf"))
    bs[:, :Tk] = (0.0 if bias is None else
                  bias.float().repeat_interleave(H, 0) * _f32(LOG2E))
    scale2 = _f32(scale) * _f32(LOG2E)
    dq = torch.zeros_like(qf)
    for q0 in range(0, Tq, M):
        qs = slice(q0, q0 + M)
        rows = torch.arange(q0, q0 + M)[:, None]
        # causal: key tiles at or past the tile's last row + 1 are skipped
        k_end = min(Tk, q0 + M) if causal and skip else Tk
        for k0 in range(0, k_end, n):
            ks = slice(k0, k0 + n)
            s = qf[:, qs] @ kf[:, ks].transpose(1, 2)
            x = (s * scale2 + bs[:, None, ks]) - lse2[:, qs, None]
            if causal and (k0 + n - 1 > q0 or not skip):
                x = torch.where(torch.arange(k0, k0 + n)[None, :] > rows,
                                -float("inf"), x)
            p = torch.exp2(x)
            dp = gf[:, qs] @ vf[:, ks].transpose(1, 2)
            ds = p * (dp - dl[:, qs, None])
            dq[:, qs] += ds.to(lp).float() @ kf[:, ks]
    return (scale * dq)[:, :Tq].reshape(B, H, Tq, D).to(lp)


def _case(dtype, D, Tq, Tk, mask, seed):
    """Numpy inputs (q, k, v, dout; with the padding mask a bias whose
    second batch row masks every key) and their torch 16-bit copies."""
    rng = np.random.RandomState(seed)
    B, H = 2, 2
    q, g = (rng.randn(B, H, Tq, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, H, Tk, D).astype(np.float32) for _ in range(2))
    bias = None
    if mask == "padding":
        lens = np.array([max(1, Tk - 37), 0])
        bias = np.where(np.arange(Tk)[None, :] < lens[:, None], 0.0,
                        -1e30).astype(np.float32)
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v, g)]
    return (q, k, v, g, bias), t + [None if bias is None
                                    else torch.from_numpy(bias)]


def _rel(got, want):
    got, want = got.float(), torch.as_tensor(np.array(want, np.float32))
    return float((got - want).abs().max()) / max(
        1.0, float(want.abs().max()))


CASES = [(16, 100, 130, "padding"), (64, 100, 130, "none"),
         (64, 130, 70, "padding"), (64, 130, 130, "causal"),
         (128, 100, 70, "padding"), (128, 70, 100, "causal"),
         (256, 40, 70, "padding"), (256, 70, 40, "causal")]


@pytest.mark.parametrize("D,Tq,Tk,mask", CASES,
                         ids=[f"D{c[0]}-{c[1]}x{c[2]}-{c[3]}" for c in CASES])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_backward_tiles_match_twins_and_jax(dtype, D, Tq, Tk, mask):
    """The emulated kernels against the port's twins (the same lse and
    delta) and against JAX's ``_flash_backward`` in interpret mode (its
    own lse and delta) on the same inputs: dq, dk, dv and, with a mask,
    dbias (per head against the twin, summed over heads against JAX),
    all finite, within LP_TOL."""
    causal = mask == "causal"
    (q, k, v, g, bias), (tq, tk, tv, tg, tb) = _case(dtype, D, Tq, Tk,
                                                     mask, D + Tq + Tk)
    scale = D ** -0.5
    out, lse = tfa.flash_forward_reference(tq, tk, tv, tb, causal, scale)
    delta = tfa._delta(out, tg)
    args = (tq, tk, tv, tb, tg, lse, delta, causal, scale)
    dk, dv, db = emulate_dkv(*args)
    dq = emulate_dq(*args)
    for x in (dk, dv, db, dq):
        assert bool(torch.isfinite(x).all())
    tol = LP_TOL[dtype]
    r_dk, r_dv, r_db = tfa.flash_bwd_dkv_reference(*args, want_dbias=True) \
        if tb is not None else tfa.flash_bwd_dkv_reference(*args)
    r_dq = tfa.flash_bwd_dq_reference(*args)
    for got, want, name in ((dq, r_dq, "dq"), (dk, r_dk, "dk"),
                            (dv, r_dv, "dv")):
        assert got.dtype == want.dtype == dtype
        assert _rel(got, want.float()) < tol, name
    if tb is not None:
        assert _rel(db, r_db) < tol, "dbias"

    jdt = getattr(jnp, str(dtype).split(".")[-1])
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    jb = None if bias is None else jnp.asarray(bias)
    bq = min(jfa.DEFAULT_BLOCK_Q, max(Tq, 8))
    bk = min(jfa.DEFAULT_BLOCK_K, max(Tk, 8))
    j_out, j_lse = jfa._flash_forward(jq, jk, jv, jb, causal, None, bq, bk,
                                      True, want_lse=True)
    j_dq, j_dk, j_dv, j_db = jfa._flash_backward(
        jq, jk, jv, jb, j_out, j_lse, jg, causal, None, bq, bk, True)
    for got, want, name in ((dq, j_dq, "dq"), (dk, j_dk, "dk"),
                            (dv, j_dv, "dv")):
        assert _rel(got, want.astype(jnp.float32)) < tol, name
    if tb is not None:
        B, H = q.shape[:2]
        assert _rel(db.reshape(B, H, Tk).sum(1), j_db) < tol, "dbias"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_all_masked_row_weighs_every_key_alike(dtype):
    """A batch row of valid length 0: its lse is -1e30 in f32, and in
    log2 units the masked bias and the lse scale to the same value, so
    each probability of the row is exactly 1, as the twin's exp(s - lse)
    gives; dV of each key of that row is then the sum of dout over the
    queries."""
    _, (tq, tk, tv, tg, tb) = _case(dtype, 64, 70, 90, "padding", 3)
    scale = 0.125
    out, lse = tfa.flash_forward_reference(tq, tk, tv, tb, False, scale)
    row = lse.reshape(2, 2, 70)[1]
    assert float(row.max()) == float(row.min()) == float(_f32(-1e30))
    s = (tq[1].float() @ tk[1].float().transpose(1, 2))[0, 0]
    x = (s * _f32(scale * LOG2E) + tb[1, 0] * _f32(LOG2E)) \
        - lse[2, 0] * _f32(LOG2E)
    assert bool((torch.exp2(x) == 1.0).all())
    delta = tfa._delta(out, tg)
    args = (tq, tk, tv, tb, tg, lse, delta, False, scale)
    _, dv, _ = emulate_dkv(*args)
    want = tg[1].float().sum(1, keepdim=True).expand(2, 90, 64)
    assert _rel(dv[1], want) < LP_TOL[dtype]
    _, r_dv, _ = tfa.flash_bwd_dkv_reference(*args)
    assert _rel(dv, r_dv.float()) < LP_TOL[dtype]


@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_causal_tile_skip_drops_only_masked_pairs(D):
    """Skipping the tiles above the diagonal (dK/dV: query tiles before
    the key tile; dQ: key tiles past the query tile) changes nothing: the
    emulation with the skip equals, bit for bit, the same arithmetic with
    every tile visited and masked; and it agrees with the twins."""
    dtype = torch.bfloat16
    _, (tq, tk, tv, tg, tb) = _case(dtype, D, 130, 130, "causal", D)
    scale = D ** -0.5
    out, lse = tfa.flash_forward_reference(tq, tk, tv, tb, True, scale)
    delta = tfa._delta(out, tg)
    args = (tq, tk, tv, tb, tg, lse, delta, True, scale)
    for fn in (emulate_dkv, emulate_dq):
        got, every = fn(*args), fn(*args, skip=False)
        got, every = ((x if isinstance(x, tuple) else (x,))
                      for x in (got, every))
        assert all(torch.equal(a, b) for a, b in zip(got, every))
    r_dk, r_dv, _ = tfa.flash_bwd_dkv_reference(*args)
    dk, dv, _ = emulate_dkv(*args)
    assert _rel(dk, r_dk.float()) < LP_TOL[dtype]
    assert _rel(dv, r_dv.float()) < LP_TOL[dtype]
    r_dq = tfa.flash_bwd_dq_reference(*args)
    assert _rel(emulate_dq(*args), r_dq.float()) < LP_TOL[dtype]

"""PyTorch port: the launch plan and the split-and-merge arithmetic of
the staged paged-attention kernel (``paged_ring_kernel`` in
``mxnet_tpu_torch/csrc/ragged_flat.cu``: the quantised flat kernel and
the chunk kernel), and the head-dim padding of the flash kernels' wrappers.

The kernel runs only on the card. What these CPU tests hold:

- ``paged_plan``: its choices at the main path's shapes, every stage
  within the shared memory it budgets, and the kv split
  (``page_shares``, then sub-walks taking every subs-th page of a share)
  covering each live page of a row exactly once;
- the kernel's arithmetic, written once here in float64 numpy
  (``staged_attention``): per (split, sub-walk), an online softmax over
  its pages 16 slots at a time, the scale on the reduced score and on
  the weight, masked scores at -1e30 weighing exactly 0; then each
  split's sub-walks folded in order, and the splits merged in rank
  order. It must agree with the port's
  plain ``ragged_flat_attention_reference`` /
  ``ragged_chunk_attention_reference`` and with the JAX package's
  ``ragged_flat_attention`` / ``ragged_paged_attention`` (through their
  references) at D = 16 and D = 64, int8/fp8 scales included. Tolerance
  1e-5: f32 inputs, sums in another order, outputs O(1);
- the flash pad identity: the plain forward and backward on q, k, v
  (and dout) zero-padded to the next instantiated head dim, with the
  scale of the true D, equal the unpadded results at D = 48 and 80
  (tolerance 1e-5, the same sums with zero terms added).
"""
import os
import sys

import ml_dtypes
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu.ops import ragged_attention as jra  # noqa: E402
from mxnet_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from mxnet_tpu_torch.ops import ragged_attention as tra  # noqa: E402
from mxnet_tpu_torch.serving.llm.model import _quantize_kv  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5
NEG = -1e30
SLOTS = 16                   # slots per softmax step of the kernel
# the card's budget: shared memory for two CTAs an SM, and one CTA's most
TWO_PER_SM = 228 * 1024 // 2 - 1024
MAX_SMEM = 232448


# ------------------------------------------------------------- plan --
@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn])
def test_plan_quantised_flat_at_the_main_path_shapes(dtype):
    """GPT-2-small widths (H=12, D=64, block 16, 64 table columns):
    a decode step of 8 tokens gets 8 rows x 3 head groups x 8 splits =
    192 CTAs of 4 heads, each pair walked by 2 warps (a stage of two
    pages, 17 KB); a 128-token prefill pack already has 384 CTAs and
    splits 3 ways (8 x 132 wanted), one warp a pair."""
    heads, splits, stages, subs = tra.paged_plan(8, 1, 12, 64, 16, 64, dtype)
    assert (heads, splits, subs) == (4, 8, 2)
    assert 8 * (12 // heads) * splits == 192
    assert stages == 4
    assert tra.paged_plan(128, 1, 12, 64, 16, 64, dtype) == (4, 3, 4, 1)
    heads, splits, _, _ = tra.paged_plan(4096, 1, 12, 64, 16, 64, dtype)
    assert splits == 1


def test_plan_chunk_at_the_main_path_shapes():
    """A 16-token chunk takes one head per CTA (16 pairs, 8 warps of 2
    pairs); decode_step's Q=1 takes 4 heads, one warp a pair (two f32
    pages of 4 heads would pass the 32 KB stage)."""
    assert tra.paged_plan(8, 16, 12, 64, 16, 64, torch.float32) == \
        (1, 8, 4, 1)
    assert tra.paged_plan(8, 1, 12, 64, 16, 64, torch.float32) == \
        (4, 8, 3, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8,
                                   torch.float8_e4m3fn])
@pytest.mark.parametrize("Q", [1, 4, 16, 20])
@pytest.mark.parametrize("H,D,bs", [(12, 64, 16), (2, 16, 8), (4, 48, 5),
                                    (16, 128, 16), (3, 256, 16),
                                    (1, 1, 1), (7, 96, 32)])
def test_plan_stays_within_shared_memory(dtype, Q, H, D, bs):
    MB = 64
    heads, splits, stages, subs = tra.paged_plan(8, Q, H, D, bs, MB, dtype)
    qt = min(Q, 16)
    assert H % heads == 0 and 1 <= splits <= min(8, MB)
    assert 2 <= stages <= 4 and subs >= 1
    assert qt * heads * subs <= max(8, qt * heads) <= 64
    stage, smem = tra.ring_smem_bytes(bs, heads, D, dtype, qt, stages, MB,
                                      subs)
    assert smem <= TWO_PER_SM or (heads, subs, stages) == (1, 1, 2)
    assert smem <= MAX_SMEM
    # the stage holds subs pages of K and V (and scales) for the group
    elem = dtype.itemsize
    assert stage >= subs * 2 * bs * heads * D * elem


def test_plan_refuses_a_page_that_does_not_fit():
    with pytest.raises(ValueError, match="block_size"):
        tra.paged_plan(8, 1, 2, 256, 1024, 4, torch.float32)


def _walks(n_live, splits, subs):
    """The pages each (rank, sub-walk) reads, as the kernel assigns
    them: the rank's share, then every subs-th page of it; one list of
    sub-walks per rank."""
    return [[list(range(first + s, end, subs)) for s in range(subs)]
            for first, end in tra.page_shares(n_live, splits)]


@pytest.mark.parametrize("n_live", [0, 1, 2, 7, 8, 9, 63, 64])
@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("subs", [1, 2, 8])
def test_every_live_page_is_read_exactly_once(n_live, splits, subs):
    pages = sorted(p for rank in _walks(n_live, splits, subs)
                   for w in rank for p in w)
    assert pages == list(range(n_live))
    shares = tra.page_shares(n_live, splits)
    assert len(shares) == splits
    assert all(a <= b for a, b in shares)
    assert [b - a for a, b in shares if b > a] == sorted(
        (b - a for a, b in shares if b > a), reverse=True)


def test_live_pages_follow_the_horizon():
    assert tra.live_pages(-1, 16, 64) == 0
    assert [tra.live_pages(h, 16, 64) for h in (0, 15, 16, 17)] == \
        [1, 1, 2, 2]
    assert tra.live_pages(10 ** 6, 16, 64) == 64


# ------------------------------------------- split-and-merge arithmetic --
def _state(q, pages, horizon, kp, vp, ks, vs, table, bs, scale):
    """One (rank, sub-walk) of the kernel for one token and head: (m, l,
    acc) after its pages, 16 slots at a time."""
    D = q.shape[0]
    m, l, acc = NEG, 0.0, np.zeros(D)
    N = kp.shape[0]
    for j in pages:
        pid = min(max(int(table[j]), 0), N - 1)
        for s0 in range(0, bs, SLOTS):
            slots = np.arange(s0, min(bs, s0 + SLOTS))
            live = j * bs + slots <= horizon
            if not live.any():
                break
            sc = kp[pid, slots] @ q
            if ks is not None:
                sc = sc * ks[pid, slots]
            sc = np.where(live, sc * scale, NEG)
            m_new = max(m, float(sc.max()))
            alpha = np.exp(m - m_new)
            p = np.exp(sc - m_new) * live
            l = l * alpha + p.sum()
            w = p * vs[pid, slots] if vs is not None else p
            acc = acc * alpha + (w[live, None] * vp[pid, slots][live]).sum(0)
            m = m_new
    return m, l, acc


def _fold(states):
    """Online-softmax states folded in order into one (m, l, acc)."""
    m_all = max(m for m, _, _ in states)
    l_all = sum(l * np.exp(m - m_all) for m, l, _ in states)
    acc = sum(a * np.exp(m - m_all) for m, _, a in states)
    return m_all, l_all, acc


def _merge(ranks):
    """Each rank's sub-walks folded first, then the ranks in order; the
    denominator floored at 1e-30."""
    _, l_all, acc = _fold([_fold(subs) for subs in ranks])
    return acc / max(l_all, 1e-30)


def staged_attention(q, kp, vp, tables, tiles, scale, plan, ks=None,
                     vs=None):
    """The kernel's result for query tiles ``[(token indices, table row,
    horizon of the first token, tokens with a contract)]`` over q ``[T,
    H, D]``: per tile the live pages of its last valid token, split by
    ``plan``'s (splits, subs), each token masking by its own horizon."""
    _, splits, _, subs = plan
    T, H, D = q.shape
    bs, MB = kp.shape[1], tables.shape[1]
    out = np.zeros((T, H, D))
    for toks, row, hz0, nq in tiles:
        n_live = tra.live_pages(hz0 + nq - 1, bs, MB) if nq else 0
        walks = _walks(n_live, splits, subs)
        for i in range(nq):
            for h in range(H):
                states = [[_state(q[toks[i], h], w, hz0 + i, kp[:, :, h],
                                  vp[:, :, h],
                                  None if ks is None else ks[:, :, h],
                                  None if vs is None else vs[:, :, h],
                                  tables[row], bs, scale) for w in rank]
                          for rank in walks]
                out[toks[i], h] = _merge(states)
    return out


def _pool(rng, D, H=2, bs=8, MB=6, S=3, dtype="float32"):
    N = S * MB + 1
    tables = rng.permutation(np.arange(1, N)).astype(np.int32)[
        :S * MB].reshape(S, MB)
    kf = rng.randn(N, bs, H, D).astype(np.float32)
    vf = rng.randn(N, bs, H, D).astype(np.float32)
    if dtype == "float32":
        return tables, kf, vf, None, None, kf, vf
    dt = torch.int8 if dtype == "int8" else torch.float8_e4m3fn
    out = []
    for x in (kf, vf):
        xq, sc = _quantize_kv(torch.from_numpy(x).reshape(-1, H, D), dt)
        out += [xq.reshape(N, bs, H, D), sc.reshape(N, bs, H)]
    kq, ks, vq, vs = out
    # the pages as the kernel reads them (bytes, widened to f64 here)
    return (tables, kq.float().numpy(), vq.float().numpy(),
            ks.numpy(), vs.numpy(), kq, vq)


def _to_jax(t):
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy().view(
            ml_dtypes.float8_e4m3fn))
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("dtype", ["int8", "fp8", "float32"])
def test_staged_flat_arithmetic_matches_references(D, dtype):
    rng = np.random.RandomState(D)
    H, bs, MB, S = 2, 8, 6, 3
    tables, kp, vp, ks, vs, kt, vt = _pool(rng, D, H, bs, MB, S, dtype)
    T = 7
    seq_ids = np.array([0, 0, 1, 2, 2, 1, 0], np.int32)
    positions = np.array([bs - 1, bs, 0, 2 * bs + 1, MB * bs - 1, 33, 5],
                         np.int32)
    q = rng.randn(T, H, D).astype(np.float32)
    scale = float(D ** -0.5)
    plan = tra.paged_plan(T, 1, H, D, bs, MB,
                          {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
                           "float32": torch.float32}[dtype])
    tiles = [([t], int(seq_ids[t]), int(positions[t]), 1) for t in range(T)]
    for splits, subs in ((plan[1], plan[3]), (3, 2), (8, 1), (1, 1)):
        got = staged_attention(q, kp, vp, tables, tiles, scale,
                               (plan[0], splits, plan[2], subs), ks, vs)
        kw = {}
        if ks is not None:
            kw = dict(k_scales=torch.from_numpy(ks),
                      v_scales=torch.from_numpy(vs))
        want = tra.ragged_flat_attention_reference(
            torch.from_numpy(q), kt if ks is not None else torch.from_numpy(kp),
            vt if ks is not None else torch.from_numpy(vp),
            torch.from_numpy(tables), torch.from_numpy(seq_ids),
            torch.from_numpy(positions), scale, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        jkw = {}
        if ks is not None:
            jkw = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
        jwant = np.asarray(jra.ragged_flat_attention(
            jnp.asarray(q), _to_jax(kt) if ks is not None else jnp.asarray(kp),
            _to_jax(vt) if ks is not None else jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(seq_ids),
            jnp.asarray(positions), scale=scale, use_pallas=False, **jkw))
        np.testing.assert_allclose(got, jwant, rtol=0, atol=TOL)


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("Q", [1, 5, 18])
def test_staged_chunk_arithmetic_matches_references(D, Q):
    """Chunk rows of ``Q`` tokens in tiles of 16, kv lengths at block
    edges, a row with q_len 0 (no output contract: the kernel gives 0)."""
    rng = np.random.RandomState(100 + D + Q)
    H, bs, MB, S = 2, 8, 6, 4
    tables, kp, vp, _, _, _, _ = _pool(rng, D, H, bs, MB, S)
    kv = np.array([bs - 1, bs, 2 * bs + 1, MB * bs], np.int32)
    ql = np.minimum(Q, kv).astype(np.int32)
    ql[1] = 0
    q = rng.randn(S, Q, H, D).astype(np.float32)
    scale = float(D ** -0.5)
    plan = tra.paged_plan(S, Q, H, D, bs, MB, torch.float32)
    tiles = []
    for s in range(S):
        for q0 in range(0, Q, 16):
            nq = max(0, min(min(16, Q - q0), int(ql[s]) - q0))
            toks = [s * Q + q0 + i for i in range(min(16, Q - q0))]
            tiles.append((toks, s, int(kv[s] - ql[s]) + q0, nq))
    for splits, subs in ((plan[1], plan[3]), (3, 2), (8, 4)):
        got = staged_attention(q.reshape(S * Q, H, D), kp, vp, tables, tiles,
                               scale, (plan[0], splits, plan[2], subs))
        got = got.reshape(S, Q, H, D)
        valid = np.arange(Q)[None, :] < ql[:, None]
        assert not got[~valid].any()
        want = tra.ragged_chunk_attention_reference(
            torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(tables), torch.from_numpy(kv),
            torch.from_numpy(ql), scale).numpy()
        np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=TOL)
        jwant = np.asarray(jra.ragged_paged_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(kv), q_lens=jnp.asarray(ql),
            scale=scale, use_pallas=False))
        np.testing.assert_allclose(got[valid], jwant[valid], rtol=0,
                                   atol=TOL)


# ------------------------------------------------------- flash padding --
@pytest.mark.parametrize("D", [48, 80])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_pad_identity(D, causal):
    """What the flash wrappers do for a head dim the kernels are not
    instantiated for: zero-pad to the next one, keep the true scale,
    slice the outputs back."""
    Dp = tfa.kernel_head_dim(D)
    assert Dp == {48: 64, 80: 128}[D]
    g = torch.Generator().manual_seed(D)
    B, H, T = 2, 2, 24
    q, k, v, dout = (torch.randn(B, H, T, D, generator=g) for _ in range(4))
    bias = torch.zeros(B, T)
    bias[1, 17:] = -1e30
    scale = D ** -0.5

    def pad(x):
        return torch.nn.functional.pad(x, (0, Dp - D))
    out, lse = tfa.flash_forward_reference(q, k, v, bias, causal, scale)
    out_p, lse_p = tfa.flash_forward_reference(pad(q), pad(k), pad(v), bias,
                                               causal, scale)
    assert float((out_p[..., D:]).abs().max()) == 0.0
    torch.testing.assert_close(out_p[..., :D], out, rtol=0, atol=TOL)
    torch.testing.assert_close(lse_p, lse, rtol=0, atol=TOL)
    want = tfa.flash_backward_reference(q, k, v, bias, out, lse, dout,
                                        causal, scale)
    got = tfa.flash_backward_reference(pad(q), pad(k), pad(v), bias, out_p,
                                       lse_p, pad(dout), causal, scale)
    for a, b in zip(got[:3], want[:3]):
        assert float(a[..., D:].abs().max()) == 0.0
        torch.testing.assert_close(a[..., :D], b, rtol=0, atol=TOL)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=TOL)


def test_flash_kernel_head_dims():
    assert [tfa.kernel_head_dim(d) for d in (1, 16, 17, 33, 64, 65, 128)] \
        == [16, 16, 32, 64, 64, 128, 128]

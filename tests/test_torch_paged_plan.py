"""PyTorch port: the launch plan, the query tiles and the split-and-merge
arithmetic of the staged paged-attention kernel (``paged_ring_kernel`` in
``mxnet_tpu_torch/csrc/ragged_flat.cu``: the flat kernels, f32 and
quantised, the chunk and the decode kernel), and the head-dim padding of
the flash kernels' wrappers.

The kernel runs only on the card. What these CPU tests hold:

- ``paged_plan`` and ``flat_plan``: their choices at the main path's
  shapes, every stage within the shared memory it budgets, and the kv
  split
  (``page_shares``: contiguous shares, or pages dealt to the cluster's
  ranks in turn under the pack-independent plan, then sub-walks taking
  every subs-th page of a share) covering each live page of a row
  exactly once, a token seeing the same pages in each dealt walk
  whatever its tile;
- the kernel's arithmetic, written once here in float64 numpy
  (``staged_attention``): per (split, sub-walk), an online softmax over
  its pages 16 slots at a time, the scale on the reduced score and on
  the weight, masked scores at -1e30 weighing exactly 0; then each
  split's sub-walks folded in order, and the splits merged in rank
  order. It must agree with the port's
  plain ``ragged_flat_attention_reference`` /
  ``ragged_chunk_attention_reference`` and with the JAX package's
  ``ragged_flat_attention`` / ``ragged_paged_attention`` (through their
  references) at D = 16 and D = 64, int8/fp8 scales and bf16/f16 pages
  (read as f32) included. Tolerance 1e-5: f32 inputs, sums in another
  order, outputs O(1);
- the flat kernels' query tiles (``flat_tiles``, the kernel's
  ``FlatTiles`` in Python): slots of ``qt`` tokens cut at the starts of
  the pack's runs. Every token lies in exactly one tile of consecutive
  positions of one row, and the staged arithmetic over those tiles
  agrees with both references on engine-shaped packs (runs of 16, of 1,
  mixed) and adversarial ones (unsorted, repeated tokens, gaps, stale
  padding, out-of-range seq_ids, runs longer than 16);
- the flash pad identity: the plain forward and backward on q, k, v
  (and dout) zero-padded to the next instantiated head dim, with the
  scale of the true D, equal the unpadded results at D = 48, 80 and 160
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
THREE_PER_SM = 228 * 1024 // 3 - 1024
MAX_SMEM = 232448


# ------------------------------------------------------------- plan --
@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn])
def test_plan_quantised_flat_at_the_main_path_shapes(dtype):
    """GPT-2-small widths (H=12, D=64, block 16, 64 table columns, 8
    rows): a decode step of 8 tokens gets one-token tiles, 8 rows x 3
    head groups x 8 splits = 192 CTAs of 4 heads, each pair walked by 2
    warps (a stage of two pages, 17 KB); a 128-token prefill pack gets
    16-token tiles (16 tokens a row on average), one head a CTA, 8 x 12
    x 8 = 768 CTAs, one warp per 2 pairs. The pack-independent plan (the
    draft's) keeps the decode step's splits and sub-walks at any pack,
    so that a row's bits do not move with it, even at 4096 tokens."""
    qt, heads, splits, stages, subs = tra.flat_plan(8, 8, 12, 64, 16, 64,
                                                    dtype, False)
    assert (qt, heads, splits, subs) == (1, 4, 8, 2)
    assert 8 * (12 // heads) * splits == 192
    assert stages == 4
    assert tra.flat_plan(128, 8, 12, 64, 16, 64, dtype, False) == \
        (16, 1, 8, 4, 1)
    _, heads, splits, _, _ = tra.flat_plan(4096, 8, 12, 64, 16, 64, dtype,
                                           False)
    assert splits == 1
    assert tra.flat_plan(8, 8, 12, 64, 16, 64, dtype) == (1, 4, 8, 4, 2)
    assert tra.flat_plan(128, 8, 12, 64, 16, 64, dtype) == (16, 1, 8, 4, 2)
    _, heads, splits, _, subs = tra.flat_plan(4096, 8, 12, 64, 16, 64,
                                              dtype)
    assert (splits, subs) == (8, 2)


def test_plan_chunk_at_the_main_path_shapes():
    """A 16-token chunk takes one head per CTA (16 pairs, 8 warps of 2
    pairs); decode_step's Q=1 takes 4 heads, one warp a pair (two f32
    pages of 4 heads would pass the 32 KB stage)."""
    assert tra.paged_plan(8, 16, 12, 64, 16, 64, torch.float32) == \
        (1, 8, 4, 1)
    assert tra.paged_plan(8, 1, 12, 64, 16, 64, torch.float32) == \
        (4, 8, 3, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8,
                                   torch.float8_e4m3fn, torch.bfloat16,
                                   torch.float16])
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


@pytest.mark.parametrize("T,plan", [
    (8, (1, 4, 8, 3, 1)),     # a decode step: K4's Q=1 plan
    (64, (8, 2, 8, 4, 1)),    # 8 tokens a row: 2 heads x 8 tokens a CTA
    (128, (16, 1, 8, 4, 1)),  # 16-token chunks: K4's Q=16 plan
])
def test_plan_f32_flat_at_the_main_path_shapes(T, plan):
    """K1 at GPT-2-small widths over 8 rows: slots of the mean tokens per
    row, each at the chunk kernel's plan for that many tokens."""
    assert tra.flat_plan(T, 8, 12, 64, 16, 64, torch.float32) == plan
    qt = plan[0]
    assert plan[1:] == tra.paged_plan(-(-T // qt), qt, 12, 64, 16, 64,
                                      torch.float32)


@pytest.mark.parametrize("S,plan", [
    (8, (4, 8, 3, 1)),    # 24 clusters of 8: 192 CTAs, one wave
    (64, (4, 6, 2, 1)),   # 192 clusters of 6: 1152 CTAs
    (128, (4, 3, 2, 1)),  # 384 clusters of 3: 1152 CTAs
])
def test_plan_decode_at_the_main_path_shapes(S, plan):
    """K5: one token a row, so the chunk kernel's Q=1 plan; splits fill
    the card (8 x 132 CTAs wanted) up to 8 a cluster. A launch of more
    CTAs than two an SM take at once keeps two stages, so that three
    CTAs share an SM."""
    assert tra.paged_plan(S, 1, 12, 64, 16, 64, torch.float32) == plan
    heads, splits, stages = plan[:3]
    assert S * (12 // heads) * splits >= min(8 * 132, S * 3 * 8)
    smem = tra.ring_smem_bytes(16, heads, 64, torch.float32, 1, stages,
                               64)[1]
    assert smem <= (TWO_PER_SM if stages == 3 else THREE_PER_SM)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_plan_16bit_pages_at_the_main_path_shapes(dtype):
    """bf16/f16 pages take 2 bytes an element and no scale tiles, so a
    stage of 4 heads is half the f32 one: a decode step's one-token
    tiles (K1 at T=8, K4 at Q=1, K5 at 8 rows) get 2 sub-walk warps a
    pair and a 3-stage ring of 32 KB stages, as K2 gets them; the
    16-token tiles (K1 at T=128, K4 at Q=16) keep the f32 plan, but for
    K1's pack-independent plan, which keeps the decode step's 2
    sub-walks at any pack; K5 at 64 rows takes 4 stages."""
    assert tra.ring_smem_bytes(16, 4, 64, dtype, 1, 3, 64, 2) == \
        (2 * 2 * 16 * 4 * 64 * 2, 4 * (4 * 64 * 3 + 2 * 2 * 4 + 64)
         + 3 * 2 * 2 * 16 * 4 * 64 * 2)
    for fixed in (False, True):
        assert tra.flat_plan(8, 8, 12, 64, 16, 64, dtype, fixed) == \
            (1, 4, 8, 3, 2)
    assert tra.flat_plan(128, 8, 12, 64, 16, 64, dtype, False) == \
        (16, 1, 8, 4, 1)
    assert tra.flat_plan(128, 8, 12, 64, 16, 64, dtype) == (16, 1, 8, 4, 2)
    assert tra.paged_plan(8, 16, 12, 64, 16, 64, dtype) == (1, 8, 4, 1)
    assert tra.paged_plan(8, 1, 12, 64, 16, 64, dtype) == (4, 8, 3, 2)
    assert tra.paged_plan(64, 1, 12, 64, 16, 64, dtype) == (4, 6, 4, 1)


def test_plan_refuses_a_page_that_does_not_fit():
    with pytest.raises(ValueError, match="block_size"):
        tra.paged_plan(8, 1, 2, 256, 1024, 4, torch.float32)


def _walks(n_live, splits, subs, dealt=False):
    """The pages each (rank, sub-walk) reads, as the kernel assigns
    them: the rank's share (contiguous, or ``dealt`` to the ranks in
    turn), then every subs-th page of it; one list of sub-walks per
    rank."""
    return [[share[s::subs] for s in range(subs)]
            for share in tra.page_shares(n_live, splits, dealt)]


@pytest.mark.parametrize("n_live", [0, 1, 2, 7, 8, 9, 63, 64])
@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("subs", [1, 2, 8])
@pytest.mark.parametrize("dealt", [False, True])
def test_every_live_page_is_read_exactly_once(n_live, splits, subs, dealt):
    pages = sorted(p for rank in _walks(n_live, splits, subs, dealt)
                   for w in rank for p in w)
    assert pages == list(range(n_live))
    shares = tra.page_shares(n_live, splits, dealt)
    assert len(shares) == splits
    assert all(share == sorted(share) for share in shares)
    assert [len(s) for s in shares] == sorted(
        (len(s) for s in shares), reverse=True)
    if not dealt:
        assert [p for share in shares for p in share] == list(range(n_live))


@pytest.mark.parametrize("splits,subs", [(1, 1), (3, 2), (8, 1), (8, 2)])
def test_a_tokens_walks_do_not_depend_on_its_tile(splits, subs):
    """Pages dealt to the ranks in turn (the pack-independent plan): the
    pages a token sees in each (rank, sub-walk), in walk order, are the
    same whatever the largest horizon of the tile it rides in (its
    pack): a page past its own horizon changes no state, so its bits do
    not move with the pack."""
    for own in range(0, 40):
        alone = _walks(own, splits, subs, True)
        for tile in range(own, 64):
            packed = _walks(tile, splits, subs, True)
            seen = [[[p for p in w if p < own] for w in rank]
                    for rank in packed]
            assert seen == alone, (own, tile)


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
                     vs=None, dealt=False):
    """The kernel's result for query tiles ``[(indices of the tokens with
    a contract, table row, their horizons)]`` over q ``[T, H, D]``: per
    tile the live pages of its largest horizon, split by ``plan``'s
    (splits, subs) in contiguous or ``dealt`` shares, each token masking
    by its own horizon; other tokens give 0."""
    _, splits, _, subs = plan
    T, H, D = q.shape
    bs, MB = kp.shape[1], tables.shape[1]
    out = np.zeros((T, H, D))
    for toks, row, hz in tiles:
        n_live = tra.live_pages(max(hz), bs, MB) if toks else 0
        walks = _walks(n_live, splits, subs, dealt)
        for i in range(len(toks)):
            for h in range(H):
                states = [[_state(q[toks[i], h], w, hz[i], kp[:, :, h],
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
    if dtype in ("bfloat16", "float16"):
        # the pages as the kernel reads them: the 16-bit values, widened
        kt, vt = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (kf, vf))
        return (tables, kt.double().numpy(), vt.double().numpy(), None,
                None, kt, vt)
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
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy().view(
            ml_dtypes.float8_e4m3fn))
    return jnp.asarray(t.numpy())


def flat_tiles(seq_ids, positions, qt, S):
    """The flat kernels' query tiles (``FlatTiles``): slot x holds tokens
    x*qt .. x*qt + qt - 1; a tile starts at the slot's first token and
    at each token whose seq_id differs from the one before it, and ends
    at the next start. ``[(token indices, table row, their
    positions)]``."""
    T = len(seq_ids)
    tiles = []
    for x0 in range(0, T, qt):
        end = min(T, x0 + qt)
        starts = [y for y in range(x0, end)
                  if y == x0 or seq_ids[y - 1] != seq_ids[y]]
        for a, b in zip(starts, starts[1:] + [end]):
            row = min(max(int(seq_ids[a]), 0), S - 1)
            tiles.append((list(range(a, b)), row,
                          [int(positions[y]) for y in range(a, b)]))
    return tiles


def _flat_case(dtype, D, seq_ids, positions, S, seed):
    """Pools, q and both references' outputs for a flat pack; the
    references get the kernel's clamped seq_ids."""
    rng = np.random.RandomState(seed)
    H, bs, MB = 2, 8, 6
    tables, kp, vp, ks, vs, kt, vt = _pool(rng, D, H, bs, MB, S, dtype)
    seq_ids = np.asarray(seq_ids, np.int32)
    positions = np.asarray(positions, np.int32)
    rows = np.clip(seq_ids, 0, S - 1).astype(np.int32)
    q = rng.randn(len(seq_ids), H, D).astype(np.float32)
    scale = float(D ** -0.5)
    quant = ks is not None
    raw = dtype != "float32"     # the references take the stored pages
    kw, jkw = {}, {}
    if quant:
        kw = dict(k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
        jkw = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    want = tra.ragged_flat_attention_reference(
        torch.from_numpy(q), kt if raw else torch.from_numpy(kp),
        vt if raw else torch.from_numpy(vp), torch.from_numpy(tables),
        torch.from_numpy(rows), torch.from_numpy(positions), scale,
        **kw).numpy()
    jwant = np.asarray(jra.ragged_flat_attention(
        jnp.asarray(q), _to_jax(kt) if raw else jnp.asarray(kp),
        _to_jax(vt) if raw else jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(rows), jnp.asarray(positions), scale=scale,
        use_pallas=False, **jkw))
    return q, kp, vp, ks, vs, tables, scale, want, jwant


_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
           "float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("dtype", ["int8", "fp8", "float32", "bfloat16",
                                   "float16"])
def test_staged_flat_arithmetic_matches_references(D, dtype):
    S, bs, MB = 3, 8, 6
    seq_ids = np.array([0, 0, 1, 2, 2, 1, 0], np.int32)
    positions = np.array([bs - 1, bs, 0, 2 * bs + 1, MB * bs - 1, 33, 5],
                         np.int32)
    T = len(seq_ids)
    q, kp, vp, ks, vs, tables, scale, want, jwant = _flat_case(
        dtype, D, seq_ids, positions, S, D)
    H = q.shape[1]
    for dealt in (False, True):
        qt, *plan = tra.flat_plan(T, S, H, D, bs, MB, _DTYPES[dtype], dealt)
        tiles = flat_tiles(seq_ids, positions, qt, S)
        for splits, subs in ((plan[1], plan[3]), (3, 2), (8, 1), (1, 1)):
            got = staged_attention(q, kp, vp, tables, tiles, scale,
                                   (plan[0], splits, plan[2], subs), ks, vs,
                                   dealt)
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
            np.testing.assert_allclose(got, jwant, rtol=0, atol=TOL)


def _run(seq, p0, n):
    """n tokens of row ``seq`` at positions p0 .. p0 + n - 1."""
    return [seq] * n, list(range(p0, p0 + n))


def _pack(*runs):
    ids, pos = [], []
    for a, b in runs:
        ids += a
        pos += b
    return ids, pos


# (name, seq_ids, positions, table rows); bs 8, 6 table columns: positions
# up to 47
_PACKS = {
    # engine packs: each row's tokens contiguous, in position order
    "runs_of_16": (_pack(_run(0, 0, 16), _run(1, 20, 16), _run(2, 31, 16),
                         _run(3, 7, 16)), 4),
    "runs_of_1": (_pack(*(_run(s, 3 * s + 5, 1) for s in range(8))), 8),
    "mixed": (_pack(_run(0, 40, 1), _run(1, 9, 1), _run(2, 16, 16),
                    _run(3, 47, 1), _run(4, 0, 5), _run(5, 30, 1),
                    _run(6, 12, 1), _run(7, 2, 1)), 8),
    # engine padding: the valid tokens, then the same stale entry
    # repeated (a fresh buffer's zeros), or stale tokens of an earlier step
    "padding": (_pack(_run(1, 3, 9), _run(2, 30, 3), ([0] * 12, [0] * 12)),
                3),
    "stale_padding": (_pack(_run(1, 3, 9), _run(0, 0, 1), _run(0, 0, 1),
                            _run(2, 30, 4), _run(0, 0, 1)), 3),
    # adversarial packs
    "unsorted": (_pack(_run(0, 9, 1), _run(0, 8, 1), _run(0, 7, 1),
                       _run(1, 20, 1), _run(0, 10, 1), _run(1, 19, 1)), 2),
    "repeated": (_pack(_run(0, 5, 3), _run(0, 7, 1), _run(0, 7, 2),
                       _run(1, 4, 1), _run(1, 4, 1)), 2),
    "gapped": (_pack(([0, 0, 0, 0, 1, 1], [3, 5, 6, 8, 1, 2])), 2),
    "out_of_range_rows": (_pack(_run(7, 4, 3), _run(-2, 4, 3),
                                _run(1, 11, 3)), 3),
    "run_of_40": (_pack(_run(1, 2, 40), _run(0, 20, 3)), 2),
}


@pytest.mark.parametrize("name", sorted(_PACKS))
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_flat_tiles_cover_the_pack_and_match_references(name, dtype):
    """K1's (and K2's) query tiles over engine-shaped and adversarial
    packs: each token in exactly one tile, a tile at most qt consecutive
    tokens of one seq_id within one slot; the staged arithmetic over
    those tiles (pages up to the tile's largest position, each token
    masked by its own) agrees with both references, at the plan's kv
    split and at others."""
    (seq_ids, positions), S = _PACKS[name]
    D, bs, MB = 16, 8, 6
    T = len(seq_ids)
    qt, *plan = tra.flat_plan(T, S, 2, D, bs, MB, _DTYPES[dtype])
    tiles = flat_tiles(seq_ids, positions, qt, S)
    covered = sorted(t for toks, _, _ in tiles for t in toks)
    assert covered == list(range(T))
    for toks, row, hz in tiles:
        assert 1 <= len(toks) <= qt
        assert toks == list(range(toks[0], toks[0] + len(toks)))
        assert toks[0] // qt == toks[-1] // qt
        assert len({seq_ids[t] for t in toks}) == 1
        assert min(max(seq_ids[toks[0]], 0), S - 1) == row
        assert hz == [positions[t] for t in toks]
    q, kp, vp, ks, vs, tables, scale, want, jwant = _flat_case(
        dtype, D, seq_ids, positions, S, len(name))
    for dealt in (False, True):
        for splits, subs in ((plan[1], plan[3]), (3, 2), (1, 1)):
            got = staged_attention(q, kp, vp, tables, tiles, scale,
                                   (plan[0], splits, plan[2], subs), ks, vs,
                                   dealt)
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
            np.testing.assert_allclose(got, jwant, rtol=0, atol=TOL)


def test_flat_tiles_of_engine_packs():
    """Runs of 16 aligned to the slots give one tile a slot (a 16-token
    chunk reads its pages once); a decode step gives one tile a token; a
    run of 40 splits at the slot edges; a step's padding (the same stale
    entry repeated) fills its slots with one tile each."""
    (ids, pos), S = _PACKS["runs_of_16"]
    assert [len(t[0]) for t in flat_tiles(ids, pos, 16, S)] == [16] * 4
    (ids, pos), S = _PACKS["runs_of_1"]
    assert [len(t[0]) for t in flat_tiles(ids, pos, 1, S)] == [1] * 8
    (ids, pos), S = _PACKS["run_of_40"]
    assert [len(t[0]) for t in flat_tiles(ids, pos, 16, S)] == [16, 16, 8, 3]
    ids, pos = _pack(_run(0, 9, 16), _run(1, 3, 16), ([0] * 32, [0] * 32))
    assert [len(t[0]) for t in flat_tiles(ids, pos, 16, 8)] == [16] * 4


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
            hz0 = int(kv[s] - ql[s]) + q0
            tiles.append(([s * Q + q0 + i for i in range(nq)], s,
                          [hz0 + i for i in range(nq)]))
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
@pytest.mark.parametrize("D", [48, 80, 160])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_pad_identity(D, causal):
    """What the flash wrappers do for a head dim the kernels are not
    instantiated for: zero-pad to the next one, keep the true scale,
    slice the outputs back."""
    Dp = tfa.kernel_head_dim(D)
    assert Dp == {48: 64, 80: 128, 160: 256}[D]
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


def test_flash_kernel_head_dims_above_128():
    """129 to 256 run at the 256 instantiation (32-row tiles)."""
    assert [tfa.kernel_head_dim(d) for d in (129, 160, 192, 255, 256)] \
        == [256] * 5

"""PyTorch port, sampling: ``mxnet_tpu_torch.serving.llm.sampling``
against the JAX package's sampling on the same logits.

What is held exactly: greedy rows (bit-exact argmax) and the greedy
accept rule. ``adjusted_log_probs`` is held within ``LP_TOL = 1e-6``
(f32 softmax/log-softmax and cumulative sums in another order; the
masks must be identical). Sampled draws cannot match JAX's threefry
bits — the port draws Philox noise — so they are held by distribution:
total-variation distance between the empirical distributions of
``N_DRAWS`` draws and the target below ``TV_TOL = 0.05`` (the expected
TV of 4000 draws over 8 outcomes is about 0.02).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu.serving.llm import sampling as js  # noqa: E402
from mxnet_tpu_torch.serving.llm import sampling as ts  # noqa: E402

torch.set_num_threads(2)

LP_TOL = 1e-6
TV_TOL = 0.05
N_DRAWS = 4000


def _knobs(S, rng):
    temp = rng.choice([0.0, 0.5, 1.0, 1.7], size=S).astype(np.float32)
    top_k = rng.choice([0, 1, 3, 7], size=S).astype(np.int32)
    top_p = rng.choice([1.0, 0.9, 0.5, 0.2], size=S).astype(np.float32)
    return temp, top_k, top_p


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_adjusted_log_probs_match_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(32, 40).astype(np.float32) * 3
    temp, top_k, top_p = _knobs(32, rng)
    temp = np.maximum(temp, 0.3)
    want = np.asarray(js.adjusted_log_probs(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p)))
    got = ts.adjusted_log_probs(*_t(logits, temp, top_k, top_p)).numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=LP_TOL, rtol=0)


def test_greedy_rows_are_the_bitexact_argmax():
    rng = np.random.RandomState(1)
    logits = rng.randn(16, 50).astype(np.float32)
    S = logits.shape[0]
    temp = np.zeros(S, np.float32)
    keys = ts.row_keys(torch.arange(S), torch.full((S,), 9), ts.TAG_SAMPLE)
    got = ts.sample_tokens(*_t(logits, temp, np.zeros(S, np.int32),
                               np.ones(S, np.float32)), keys).numpy()
    jkeys = js.row_keys(jnp.arange(S, dtype=jnp.int32),
                        jnp.full((S,), 9, jnp.int32), js.TAG_SAMPLE)
    want = np.asarray(js.sample_tokens(
        jnp.asarray(logits), jnp.asarray(temp),
        jnp.zeros(S, jnp.int32), jnp.ones(S, jnp.float32), jkeys))
    assert np.array_equal(got, np.argmax(logits, -1))
    assert np.array_equal(got, want)


def _accept_inputs(seed, S=12, K=3, V=10):
    rng = np.random.RandomState(seed)
    tl = rng.randn(S, K + 1, V).astype(np.float32)
    arg = tl.argmax(-1)
    drafts = np.where(rng.rand(S, K) < 0.6, arg[:, :K],
                      rng.randint(0, V, (S, K))).astype(np.int32)
    n_draft = rng.randint(0, K + 1, S).astype(np.int32)
    probs = rng.dirichlet(np.ones(V), (S, K)).astype(np.float32)
    return tl, drafts, probs, n_draft


def test_spec_accept_greedy_matches_jax():
    tl, drafts, _, n_draft = _accept_inputs(2)
    jt, jn = js.spec_accept_greedy(jnp.asarray(tl), jnp.asarray(drafts),
                                   jnp.asarray(n_draft))
    tt, tn = ts.spec_accept_greedy(*_t(tl, drafts, n_draft))
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    assert np.array_equal(tt.numpy(), np.asarray(jt))


def test_spec_accept_greedy_rows_match_jax():
    """spec_accept with every row greedy uses no noise at all, so it
    must equal the JAX rule token for token."""
    tl, drafts, probs, n_draft = _accept_inputs(3)
    S, K = drafts.shape
    zeros = np.zeros(S, np.float32)
    ones = np.ones(S, np.float32)
    kz = np.zeros(S, np.int32)
    seeds = np.arange(S, dtype=np.int32)
    ctr = np.arange(S * (K + 1), dtype=np.int32).reshape(S, K + 1)
    jt, jn = js.spec_accept(
        jnp.asarray(tl), jnp.asarray(drafts), jnp.asarray(probs),
        jnp.asarray(n_draft), jnp.asarray(zeros), jnp.asarray(kz),
        jnp.asarray(ones),
        js.row_keys(jnp.asarray(np.repeat(seeds[:, None], K, 1)),
                    jnp.asarray(ctr[:, :K]), js.TAG_ACCEPT),
        js.row_keys(jnp.asarray(np.repeat(seeds[:, None], K + 1, 1)),
                    jnp.asarray(ctr), js.TAG_SAMPLE))
    sd, ct = torch.from_numpy(seeds)[:, None], torch.from_numpy(ctr)
    tt, tn = ts.spec_accept(
        *_t(tl, drafts, probs, n_draft, zeros, kz, ones),
        ts.row_keys(sd.expand(S, K), ct[:, :K], ts.TAG_ACCEPT),
        ts.row_keys(sd.expand(S, K + 1), ct, ts.TAG_SAMPLE))
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    assert np.array_equal(tt.numpy(), np.asarray(jt))


def _tv(draws, p):
    emp = np.bincount(draws, minlength=len(p)) / len(draws)
    return 0.5 * float(np.abs(emp - p).sum())


@pytest.mark.parametrize("temp,top_k,top_p", [(1.0, 0, 1.0),
                                              (0.7, 5, 1.0),
                                              (1.3, 0, 0.8)])
def test_sampled_draws_match_jax_distribution(temp, top_k, top_p):
    rng = np.random.RandomState(4)
    V = 8
    logits = np.tile(rng.randn(1, V).astype(np.float32), (N_DRAWS, 1))
    tv = np.full(N_DRAWS, temp, np.float32)
    kv = np.full(N_DRAWS, top_k, np.int32)
    pv = np.full(N_DRAWS, top_p, np.float32)
    seeds = np.arange(N_DRAWS, dtype=np.int32)
    ctr = np.full(N_DRAWS, 17, np.int32)
    p = np.exp(ts.adjusted_log_probs(*_t(logits[:1], tv[:1], kv[:1],
                                         pv[:1]))[0].numpy())
    got = ts.sample_tokens(*_t(logits, tv, kv, pv), ts.row_keys(
        *_t(seeds, ctr), ts.TAG_SAMPLE)).numpy()
    want = np.asarray(js.sample_tokens(
        jnp.asarray(logits), jnp.asarray(tv), jnp.asarray(kv),
        jnp.asarray(pv), js.row_keys(jnp.asarray(seeds),
                                     jnp.asarray(ctr), js.TAG_SAMPLE)))
    assert _tv(got, p) < TV_TOL
    assert _tv(want, p) < TV_TOL
    assert p[got].min() > 0                     # masked tokens never drawn


def test_spec_accept_sampled_keeps_the_target_distribution():
    """Speculative sampling's guarantee: the committed first token is
    distributed as the target p, whatever the draft q proposed."""
    rng = np.random.RandomState(5)
    V, n = 6, N_DRAWS
    tl = np.tile(rng.randn(1, 2, V).astype(np.float32), (n, 1, 1))
    q = rng.dirichlet(np.ones(V)).astype(np.float32)
    drafts = rng.choice(V, size=(n, 1), p=q / q.sum()).astype(np.int32)
    probs = np.tile(q[None, None], (n, 1, 1))
    ones = np.ones(n, np.float32)
    seeds = torch.arange(n)[:, None]
    ctr = torch.full((n, 2), 40)
    toks, _ = ts.spec_accept(
        *_t(tl, drafts, probs, np.ones(n, np.int32), ones,
            np.zeros(n, np.int32), ones),
        ts.row_keys(seeds, ctr[:, :1], ts.TAG_ACCEPT),
        ts.row_keys(seeds.expand(n, 2), ctr, ts.TAG_SAMPLE))
    p = np.exp(ts.adjusted_log_probs(*_t(tl[:1, 0], ones[:1],
                                         np.zeros(1, np.int32),
                                         ones[:1]))[0].numpy())
    assert _tv(toks[:, 0].numpy(), p) < TV_TOL


def test_noise_is_a_pure_function_of_seed_position_tag():
    seeds = torch.tensor([1, 1, 2])
    ctr = torch.tensor([10, 10, 10])
    g = ts._gumbel(ts.row_keys(seeds, ctr, ts.TAG_SAMPLE), 33)
    assert torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    g2 = ts._gumbel(ts.row_keys(seeds, ctr + 1, ts.TAG_SAMPLE), 33)
    g3 = ts._gumbel(ts.row_keys(seeds, ctr, ts.TAG_ACCEPT), 33)
    assert not torch.equal(g[0], g2[0]) and not torch.equal(g[0], g3[0])
    assert torch.equal(g, ts._gumbel(
        ts.row_keys(seeds, ctr, ts.TAG_SAMPLE), 33))


def test_philox_matches_known_answers():
    """Philox4x32-10 known-answer vectors (Random123)."""
    z = torch.zeros(1, dtype=torch.int64)
    f = z + 0xFFFFFFFF
    assert [int(w) for w in ts.philox4x32(z, z, z, z, z, z)] == \
        [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert [int(w) for w in ts.philox4x32(f, f, f, f, f, f)] == \
        [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]

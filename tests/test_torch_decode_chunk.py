"""PyTorch port, the model interface's paged step: ``TinyDecoder
.decode_chunk`` / ``decode_step`` of ``mxnet_tpu_torch`` against the JAX
package's on the same seeded weights, pages, tables and lengths (on the
CPU, where the chunk kernel takes its plain version), and the greedy
decoding loop of ``chip_smoke.py``'s paged phase (chunked prefill, rows
done at q_len 0, then ``decode_step``) against the JAX greedy oracle.

Tolerance ``STEP_TOL = 1e-4`` (that of the port's ``decode_flat``
parity test): the same f32 math two layers deep, matmul, softmax and
attention sums in another order. Greedy streams are held token for
token. Pools are compared off the null block, which padded tokens write
in an order neither side defines.
"""
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from mxnet_tpu.serving import llm as jllm  # noqa: E402
from mxnet_tpu_torch import kernels  # noqa: E402
from mxnet_tpu_torch.convert import params_from_numpy  # noqa: E402
from mxnet_tpu_torch.serving import llm as tllm  # noqa: E402

torch.set_num_threads(2)

STEP_TOL = 1e-4
CFG = dict(vocab_size=48, d_model=32, num_layers=2, num_heads=2,
           d_ff=64, max_context=64)
BS = 8
N_BLOCKS = 12


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model, numpy params, port params)."""
    jm = jllm.TinyDecoder(jllm.DecoderConfig(**CFG))
    tm = tllm.TinyDecoder(tllm.DecoderConfig(**CFG), device="cpu")
    npp = jm.init_params(seed=0)
    return jm, tm, npp, params_from_numpy(npp, "cpu")


def _chunk_inputs(seed=0, Q=5):
    """A chunk step over pools that already hold history: row 0 adds 5
    tokens at positions 8..12 (crossing into its second block), row 1 is
    inactive (q_len 0, kv_len 1 over the null block), row 2 adds 3 tokens
    at 17..19 with a padded tail of 2 (its third block)."""
    rng = np.random.RandomState(seed)
    L, H, Dh = CFG["num_layers"], CFG["num_heads"], 16
    pools = [rng.randn(L, N_BLOCKS, BS, H, Dh).astype(np.float32)
             for _ in range(2)]
    tables = np.zeros((3, CFG["max_context"] // BS), np.int32)
    tables[0, :2] = [3, 7]
    tables[2, :3] = [5, 1, 9]
    q_lens = np.array([5, 0, 3], np.int32)
    kv_lens = np.array([13, 1, 20], np.int32)
    tokens = rng.randint(0, CFG["vocab_size"], size=(3, Q)).astype(
        np.int32)
    positions = np.zeros((3, Q), np.int32)
    for i in range(3):
        n = min(int(q_lens[i]), Q)
        positions[i, :n] = np.arange(kv_lens[i] - n, kv_lens[i])
    return tokens, positions, q_lens, pools, tables, kv_lens


def test_decode_chunk_matches_jax(pair):
    jm, tm, npp, tp = pair
    tokens, positions, q_lens, (kp, vp), tables, kv_lens = _chunk_inputs()
    jl, jk, jv = jm.decode_chunk(
        npp, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(q_lens), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(kv_lens))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl, tk2, tv2 = tm.decode_chunk(
        tp, *(torch.from_numpy(a) for a in (tokens, positions, q_lens)),
        tk, tv, torch.from_numpy(tables), torch.from_numpy(kv_lens))
    assert tk2 is tk and tv2 is tv          # written in place, returned
    for i, n in enumerate(q_lens):
        np.testing.assert_allclose(tl[i, :n].numpy(),
                                   np.asarray(jl)[i, :n], atol=STEP_TOL,
                                   rtol=0)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got[:, 1:].numpy(),
                                   np.asarray(want)[:, 1:], atol=STEP_TOL,
                                   rtol=0)
    # the valid tokens' slots changed; no other block off the null one did
    assert not np.allclose(tk[:, 7, :5].numpy(), kp[:, 7, :5])
    np.testing.assert_array_equal(tk[:, 2].numpy(), kp[:, 2])


def test_decode_step_is_decode_chunk_at_q1(pair):
    _, tm, _, tp = pair
    tokens, positions, _, (kp, vp), tables, kv_lens = _chunk_inputs(1, Q=1)
    positions[:, 0] = kv_lens - 1
    args = [torch.from_numpy(a) for a in (tables, kv_lens)]
    pools_a = [torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())]
    pools_b = [torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())]
    step, _, _ = tm.decode_step(tp, torch.from_numpy(tokens[:, 0]),
                                torch.from_numpy(positions[:, 0]),
                                *pools_a, *args)
    chunk, _, _ = tm.decode_chunk(tp, torch.from_numpy(tokens),
                                  torch.from_numpy(positions),
                                  torch.ones(3, dtype=torch.int32),
                                  *pools_b, *args)
    assert torch.equal(step, chunk[:, 0])
    for a, b in zip(pools_a, pools_b):
        assert torch.equal(a, b)


def test_chunked_prefill_and_decode_steps_match_jax_greedy(pair):
    """chip_smoke's paged phase at a small size: 3 prompts (13, 5, 20
    tokens) prefilled in chunks of 8, then 8 ``decode_step``s: 9 greedy
    tokens per row, identical to the JAX oracle's; each prompt's last
    chunk agrees with the dense forward."""
    jm, tm, npp, tp = pair
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, CFG["vocab_size"], size=n).tolist()
               for n in (13, 5, 20)]
    before = kernels.launch_counts()
    streams, last, steps, _, cache, _, _ = chip_smoke.paged_greedy(
        torch, tm, tp, prompts, 8, chunk=8, block_size=BS)
    assert steps == 3
    assert kernels.launch_counts() == before    # plain version on the CPU
    cache.check()
    for p, s, lg in zip(prompts, streams, last):
        assert s == jllm.greedy_decode_reference(jm, npp, p, 9)
        dense, _, _ = tm.forward(tp, torch.tensor([p]))
        np.testing.assert_allclose(lg.numpy(),
                                   dense[0, len(p) - lg.shape[0]:].numpy(),
                                   atol=STEP_TOL, rtol=0)

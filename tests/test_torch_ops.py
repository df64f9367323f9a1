"""PyTorch port, operators: the flat ragged paged attention and the
weight-only quantized matmul of ``mxnet_tpu_torch.ops`` against the JAX
package's reference and Pallas kernels (interpret mode), on the same
numpy inputs.

Tolerances, each with its reason:

- ``ATT_TOL = 1e-5`` — port vs JAX attention, f32 pages: the same math
  in f32, softmax and dot products summed in another order (the Pallas
  kernel's online softmax walks pages one at a time); outputs are O(1).
- Quantized pages use the same bound: both sides dequantize the same
  int8/fp8 bytes with the same scales.
- ``WQ_TOL = 1e-5`` relative — quantized matmul: one f32 sum of K terms
  in another order; the Pallas kernel also scales the weights before
  the dot where the references scale after, which moves the last bit.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu.ops import ragged_attention as jra  # noqa: E402
from mxnet_tpu.ops import quantization as jqz  # noqa: E402
from mxnet_tpu.serving.llm import quant as jquant  # noqa: E402
from mxnet_tpu_torch import kernels  # noqa: E402
from mxnet_tpu_torch.ops import ragged_attention as tra  # noqa: E402
from mxnet_tpu_torch.ops import quantization as tqz  # noqa: E402
from mxnet_tpu_torch.serving.llm import quant as tquant  # noqa: E402
from mxnet_tpu_torch.serving.llm.model import _quantize_kv  # noqa: E402

torch.set_num_threads(2)

ATT_TOL = 1e-5
WQ_TOL = 1e-5
BS = 8
H, D = 2, 16


def _pages(rng, n, dtype, d):
    """(numpy pages for JAX, torch pages, numpy scales, torch scales) —
    the scales are None for f32 pages."""
    kf = rng.randn(n, BS, H, d).astype(np.float32)
    if dtype == "float32":
        return kf, torch.from_numpy(kf), None, None
    tdt = torch.int8 if dtype == "int8" else torch.float8_e4m3fn
    q, s = _quantize_kv(torch.from_numpy(kf), tdt)
    jq = q.view(torch.uint8).numpy()
    if dtype == "int8":
        jq = jq.view(np.int8)
    else:
        jq = jq.view(np.dtype(jquant.FP8_NAME))
    return jq, q, s.numpy(), s


def _case(seed, dtype, positions, seq_ids, tables, n_blocks=12, d=D):
    rng = np.random.RandomState(seed)
    q = rng.randn(len(positions), H, d).astype(np.float32)
    jk, tk, jks, tks = _pages(rng, n_blocks, dtype, d)
    jv, tv, jvs, tvs = _pages(rng, n_blocks, dtype, d)
    j = dict(q=q, k_pages=jk, v_pages=jv,
             block_tables=np.asarray(tables, np.int32),
             seq_ids=np.asarray(seq_ids, np.int32),
             positions=np.asarray(positions, np.int32))
    t = dict(q=torch.from_numpy(q), k_pages=tk, v_pages=tv,
             block_tables=torch.tensor(tables, dtype=torch.int32),
             seq_ids=torch.tensor(seq_ids, dtype=torch.int32),
             positions=torch.tensor(positions, dtype=torch.int32))
    if jks is not None:
        j.update(k_scales=jks, v_scales=jvs)
        t.update(k_scales=tks, v_scales=tvs)
    return j, t


# fragmented tables (blocks out of order, shared null padding) and
# positions at the block boundaries bs-1 / bs / bs+1 (lengths bs, bs+1,
# bs+2 counted from 0) plus a long token and a first token
TABLES = [[9, 2, 5, 0], [7, 10, 0, 0], [3, 8, 6, 4]]
SEQ_IDS = [0, 0, 0, 1, 1, 2, 2, 2]
POSITIONS = [BS - 1, BS, BS + 1, 0, 15, 3, 17, 31]


@pytest.mark.parametrize("dtype", ["float32", "int8", "fp8"])
def test_flat_attention_matches_jax_reference(dtype):
    j, t = _case(0, dtype, POSITIONS, SEQ_IDS, TABLES)
    want = np.asarray(jra.ragged_flat_attention_reference(
        *(jnp.asarray(j[k]) for k in ("q", "k_pages", "v_pages",
                                      "block_tables", "seq_ids",
                                      "positions")),
        k_scales=None if "k_scales" not in j else jnp.asarray(
            j["k_scales"]),
        v_scales=None if "v_scales" not in j else jnp.asarray(
            j["v_scales"])))
    got = tra.ragged_flat_attention(**t).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATT_TOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "int8", "fp8"])
def test_flat_attention_matches_jax_pallas_interpret(dtype):
    j, t = _case(1, dtype, POSITIONS, SEQ_IDS, TABLES)
    want = np.asarray(jra.ragged_flat_attention(
        use_pallas=True, interpret=True, **j))
    got = tra.ragged_flat_attention(**t).numpy()
    np.testing.assert_allclose(got, want, atol=ATT_TOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_flat_attention_garbage_invisible(dtype):
    """Whatever sits past each token's position — in its own last block
    or in the null block 0 — never reaches its output."""
    j, t = _case(2, dtype, POSITIONS, SEQ_IDS, TABLES)
    clean = tra.ragged_flat_attention(**t)
    for name in ("k_pages", "v_pages"):
        pool = t[name]
        big = 100 if pool.dtype == torch.int8 else 1e4
        pool[0] = big                              # the null block
        for sid, pos in zip(SEQ_IDS, POSITIONS):
            blk = TABLES[sid][pos // BS]
            later = [p for s2, p in zip(SEQ_IDS, POSITIONS)
                     if s2 == sid]
            if pos == max(later):
                pool[blk, pos % BS + 1:] = big     # past the last token
    got = tra.ragged_flat_attention(**t)
    assert torch.equal(got, clean)


def test_flat_attention_requires_both_scales():
    _, t = _case(3, "int8", POSITIONS, SEQ_IDS, TABLES)
    t.pop("v_scales")
    with pytest.raises(ValueError, match="both"):
        tra.ragged_flat_attention(**t)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_matmul_matches_jax(dtype):
    rng = np.random.RandomState(4)
    w = rng.randn(48, 80).astype(np.float32) / 7
    x = rng.randn(5, 48).astype(np.float32)
    jq, js = jquant.quantize_leaf(w, dtype)
    tq, ts = tquant.quantize_leaf(w, dtype)
    got = tqz.quantized_matmul(torch.from_numpy(x), tq, ts).numpy()
    ref = np.asarray(jqz.quantized_matmul_reference(
        jnp.asarray(x), jnp.asarray(jq), jnp.asarray(js)))
    pal = np.asarray(jqz.quantized_matmul(
        jnp.asarray(x), jnp.asarray(jq), jnp.asarray(js),
        use_pallas=True, interpret=True, block_t=8, block_n=32))
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=WQ_TOL * scale, rtol=0)
    np.testing.assert_allclose(got, pal, atol=WQ_TOL * scale, rtol=0)


def test_cpu_wrappers_never_launch_a_kernel():
    kernels.reset_launch_counts()
    builds = kernels.build_count()
    _, t = _case(5, "float32", POSITIONS, SEQ_IDS, TABLES)
    tra.ragged_flat_attention(**t)
    q, s = tquant.quantize_leaf(np.eye(4, dtype=np.float32), "int8")
    tqz.quantized_matmul(torch.ones(2, 4), q, s)
    assert kernels.launch_counts() == {}
    assert kernels.build_count() == builds


@pytest.mark.parametrize("T,K,N", [(8, 768, 768), (8, 3072, 768),
                                   (8, 768, 50257), (128, 3072, 768),
                                   (5, 100, 7), (1, 16, 3)])
def test_wq_k_splits_cover_k_in_whole_steps(T, K, N):
    """The split-K plan the kernel runs: every K slice is a whole number
    of 16-deep steps, none is empty, together they cover K exactly as
    the kernel slices it, and no launch is split below 128-deep slices
    unless K itself is shallower."""
    splits = tqz.k_splits(T, K, N)
    per = -(-(-(-K // splits)) // 16) * 16     # the kernel's slice depth
    assert splits >= 1 and per % 16 == 0
    assert (splits - 1) * per < K <= splits * per
    assert splits == 1 or K // splits >= 128 - 16

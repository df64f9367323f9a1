"""PyTorch port, paged attention in the decode and chunk shapes:
``ragged_paged_attention`` of ``mxnet_tpu_torch.ops`` (on the CPU, its
plain versions ``ragged_attention_reference`` /
``ragged_chunk_attention_reference``) against the JAX package's
``ragged_paged_attention``, through its reference and through its Pallas
kernels in interpret mode, on the same numpy inputs.

Tolerance ``rtol=2e-5, atol=2e-6`` (that of tests/test_ragged_attention.py
against its dense oracle): the same f32 math, dot products and softmax
summed in another order (the Pallas kernels' online softmax walks the
pages one at a time); outputs are O(1). Only valid tokens are compared:
padded chunk tokens have no contract. Masking is held exactly: poisoned
pages leave every valid output bit for bit as it was. bf16 and f16 pages
are read as f32 on both sides (the same tolerance); with q in the pages'
16-bit dtype, both round the f32 result to it, so the outputs agree
within one ulp of that dtype at the largest output. Pages of any other
dtype raise ``TypeError``.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""
import os
import sys

import ml_dtypes
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

from mxnet_tpu.ops import ragged_attention as jra  # noqa: E402
from mxnet_tpu_torch import kernels  # noqa: E402
from mxnet_tpu_torch.convert import tensor_from_numpy  # noqa: E402
from mxnet_tpu_torch.ops import ragged_attention as tra  # noqa: E402

torch.set_num_threads(2)

RTOL, ATOL = 2e-5, 2e-6
BS = 8
H, D = 2, 16
EDGE_MIXES = [
    [BS - 1, BS, BS + 1],
    [1, BS - 1, 2 * BS, 2 * BS + 1, 3 * BS - 1],
    [5, 11, 17, 24],
]
CHUNK_KV, CHUNK_Q = [13, 5, 2 * BS, BS + 1], [5, 2, 1, BS + 1]


def _case(kv_lens, q_lens=None, seed=0, fragment=True, num_blocks=64):
    """A paged pool holding one ragged batch, in numpy: q ``[S, H, D]``
    (decode) or ``[S, Q, H, D]`` with ``q_lens`` (chunk), pages with
    zero tails, tables padded with the null block 0."""
    rng = np.random.RandomState(seed)
    S = len(kv_lens)
    MB = max(-(-t // BS) for t in kv_lens)
    kp = np.zeros((num_blocks, BS, H, D), np.float32)
    vp = np.zeros((num_blocks, BS, H, D), np.float32)
    tables = np.zeros((S, MB), np.int32)
    pool = list(range(1, num_blocks))
    if fragment:
        np.random.RandomState(seed + 1000).shuffle(pool)
    it = iter(pool)
    qshape = (S, H, D) if q_lens is None else (S, max(q_lens), H, D)
    q = rng.randn(*qshape).astype(np.float32)
    for i, t in enumerate(kv_lens):
        k_seq = rng.randn(t, H, D).astype(np.float32)
        v_seq = rng.randn(t, H, D).astype(np.float32)
        for j in range(-(-t // BS)):
            b = next(it)
            tables[i, j] = b
            kp[b, :len(k_seq[j * BS:(j + 1) * BS])] = k_seq[j * BS:
                                                           (j + 1) * BS]
            vp[b, :len(v_seq[j * BS:(j + 1) * BS])] = v_seq[j * BS:
                                                           (j + 1) * BS]
    out = dict(q=q, k_pages=kp, v_pages=vp, block_tables=tables,
               kv_lens=np.asarray(kv_lens, np.int32))
    if q_lens is not None:
        out["q_lens"] = np.asarray(q_lens, np.int32)
    return out


def _port(c, **kw):
    t = {k: torch.from_numpy(v.copy()) for k, v in c.items()}
    return tra.ragged_paged_attention(**t, **kw).numpy()


def _jax(c, path):
    return np.asarray(jra.ragged_paged_attention(
        **c, use_pallas=(path == "pallas"), interpret=True))


def _poison(c):
    """Copy of case ``c`` with +-1e6 in every block no row references,
    in the null block, in the slots past each row's kv_len and in the
    padded chunk tokens: nothing a valid output may see."""
    p = {k: v.copy() for k, v in c.items()}
    used = set(c["block_tables"].ravel().tolist()) - {0}
    for b in range(p["k_pages"].shape[0]):
        if b not in used:
            p["k_pages"][b] = 1e6
            p["v_pages"][b] = -1e6
    for i, t in enumerate(c["kv_lens"]):
        last = c["block_tables"][i, (t - 1) // BS]
        p["k_pages"][last, t % BS or BS:] = 1e6
        p["v_pages"][last, t % BS or BS:] = -1e6
        if "q_lens" in c:
            p["q"][i, c["q_lens"][i]:] = 1e6
    return p


@pytest.mark.parametrize("lens", EDGE_MIXES, ids=["edges", "multi", "mix"])
@pytest.mark.parametrize("path", ["reference", "pallas"])
def test_decode_matches_jax(lens, path):
    c = _case(lens, seed=len(lens))
    np.testing.assert_allclose(_port(c), _jax(c, path), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("path", ["reference", "pallas"])
def test_chunk_matches_jax_on_valid_tokens(path):
    c = _case(CHUNK_KV, CHUNK_Q)
    got, want = _port(c), _jax(c, path)
    for i, qn in enumerate(CHUNK_Q):
        np.testing.assert_allclose(got[i, :qn], want[i, :qn], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("chunk", [False, True], ids=["decode", "chunk"])
def test_fragmented_table_equals_contiguous(chunk):
    q_lens = CHUNK_Q if chunk else None
    a = _port(_case(CHUNK_KV, q_lens, seed=3, fragment=True))
    b = _port(_case(CHUNK_KV, q_lens, seed=3, fragment=False))
    if chunk:
        for i, qn in enumerate(CHUNK_Q):
            np.testing.assert_array_equal(a[i, :qn], b[i, :qn])
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk", [False, True], ids=["decode", "chunk"])
def test_garbage_invisible(chunk):
    c = _case([5, 9, 17], [3, 9, 5] if chunk else None, seed=11)
    base, got = _port(c), _port(_poison(c))
    if chunk:
        for i, qn in enumerate(c["q_lens"]):
            np.testing.assert_array_equal(base[i, :qn], got[i, :qn])
    else:
        np.testing.assert_array_equal(base, got)


def test_decode_is_the_q1_slice_of_chunk():
    c = _case([5, 11, 24], seed=13)
    chunk = dict(c, q=c["q"][:, None],
                 q_lens=np.ones(3, np.int32))
    np.testing.assert_allclose(_port(chunk)[:, 0], _port(c), rtol=1e-6,
                               atol=1e-7)


def test_chunk_requires_q_lens():
    c = _case([5], seed=1)
    with pytest.raises(ValueError, match="q_lens"):
        _port(dict(c, q=c["q"][:, None]))


_NP16 = {"bfloat16": ml_dtypes.bfloat16, "float16": np.float16}


@pytest.mark.parametrize("q16", [False, True], ids=["q32", "q16"])
@pytest.mark.parametrize("dtype", sorted(_NP16))
@pytest.mark.parametrize("chunk", [False, True], ids=["decode", "chunk"])
def test_16bit_pages_match_jax(chunk, dtype, q16):
    c = _case(CHUNK_KV, CHUNK_Q if chunk else None, seed=7)
    cast = ["k_pages", "v_pages"] + (["q"] if q16 else [])
    c = dict(c, **{k: c[k].astype(_NP16[dtype]) for k in cast})
    got = tra.ragged_paged_attention(
        **{k: tensor_from_numpy(v, "cpu") for k, v in c.items()})
    assert got.dtype == (getattr(torch, dtype) if q16 else torch.float32)
    want = np.asarray(_jax(c, "pallas")).astype(np.float32)
    got = got.float().numpy()
    tol = (float(ml_dtypes.finfo(_NP16[dtype]).eps) * np.abs(want).max()
           if q16 else ATOL)
    rows = CHUNK_Q if chunk else [None] * len(CHUNK_KV)
    for i, qn in enumerate(rows):
        np.testing.assert_allclose(got[i, :qn], want[i, :qn],
                                   rtol=0 if q16 else RTOL, atol=tol)


def test_non_f32_pages_raise():
    """Pages of a dtype no kernel takes (f64) raise; bf16 and f16 pages
    are taken (``test_16bit_pages_match_jax``)."""
    c = {k: torch.from_numpy(v) for k, v in _case([5, 9]).items()}
    with pytest.raises(TypeError, match="bfloat16 or float16 pages"):
        tra.ragged_paged_attention(**dict(
            c, k_pages=c["k_pages"].double(), v_pages=c["v_pages"].double()))


def test_cpu_tensors_never_launch_a_kernel():
    before = kernels.launch_counts()
    _port(_case([5, 9]))
    _port(_case(CHUNK_KV, CHUNK_Q))
    assert kernels.launch_counts() == before

"""PyTorch port, 16-bit KV serving: ``LLMEngine``/``LLMServer`` with
``dtype="bfloat16"`` or ``"float16"`` (bf16/f16 pools), the model
interface's ``decode_chunk``/``decode_step`` over such pools, and the
paged kernels' plain versions over 16-bit pages, against the JAX package
on the same numpy inputs (on the CPU, where every kernel takes its plain
version and the JAX package's Pallas kernels run in interpret mode).

What is held, and how closely:

- served greedy streams, token for token (the argmax is exact at these
  widths); the bf16 streams differ from the f32 ones, so they prove the
  pools are 16-bit;
- the pools after serving: bf16 bit for bit (each side rounds its f32
  K/V to nearest even); f16 too, except where the two sides' f32
  projections, whose sums run in another order and differ in the last
  f32 bits, straddle an f16 rounding boundary (f16 keeps 3 more bits
  than bf16, so 8x as many values sit near one): those words are one
  ulp apart, and fewer than 1 in 200 (7 of 8064 here). The prefix
  hashes and the allocator state, exactly;
- ``decode_chunk``/``decode_step`` logits within ``STEP_TOL = 1e-5``:
  f32 math two layers deep, sums in another order, over the same 16-bit
  pools;
- the plain kernels (flat, chunk, decode) against the JAX kernels in
  interpret mode: within ``KERNEL_TOL = 1e-5`` for f32 q (both read the
  16-bit pages as f32 and sum in f32, in another order; outputs O(1));
  for 16-bit q, both round the f32 result to q's dtype, so an element on
  a rounding boundary may land one ulp apart: within one ulp of q's
  dtype at the output's largest magnitude.
"""
import os
import sys

import ml_dtypes
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu.ops import ragged_attention as jra  # noqa: E402
from mxnet_tpu.serving import llm as jllm  # noqa: E402
from mxnet_tpu_torch import kernels  # noqa: E402
from mxnet_tpu_torch.convert import (params_from_numpy,  # noqa: E402
                                     tensor_from_numpy)
from mxnet_tpu_torch.ops import ragged_attention as tra  # noqa: E402
from mxnet_tpu_torch.serving import llm as tllm  # noqa: E402
from mxnet_tpu_torch.serving.llm.kv_cache import PagedKVCache  # noqa: E402

torch.set_num_threads(2)

STEP_TOL = 1e-5
KERNEL_TOL = 1e-5
CFG = dict(vocab_size=48, d_model=32, num_layers=2, num_heads=2,
           d_ff=64, max_context=64)
BS, NEW = 8, 12
LOWP = ("bfloat16", "float16")
NP_DTYPES = {"bfloat16": ml_dtypes.bfloat16, "float16": np.float16}


def _drain(engine, seq_cls, prompts):
    seqs = [seq_cls(p, NEW) for p in prompts]
    for s in seqs:
        engine.add(s)
    for _ in range(500):
        if not engine.has_work():
            break
        engine.step()
    assert not engine.has_work()
    engine.pop_finished()
    return [s.output_tokens() for s in seqs]


def _engine_kw():
    return dict(max_seqs=4, block_size=BS, prefill_chunk=8)


@pytest.fixture(scope="module")
def ref():
    """(port model, numpy params, prompts, {dtype: the JAX engine after
    serving the prompts}, {dtype: its streams}): the JAX engine serves
    f32, bf16 and f16 pools."""
    jm = jllm.TinyDecoder(jllm.DecoderConfig(**CFG))
    tm = tllm.TinyDecoder(tllm.DecoderConfig(**CFG), device="cpu")
    npp = jm.init_params(seed=0)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, CFG["vocab_size"], size=n).tolist()
               for n in (3, 9, 17)]
    engines, streams = {}, {}
    for dt in ("float32",) + LOWP:
        eng = jllm.LLMEngine(jm, npp, dtype=dt, **_engine_kw())
        streams[dt] = _drain(eng, jllm.Sequence, prompts)
        engines[dt] = eng
    return tm, npp, prompts, engines, streams, jm


@pytest.fixture(scope="module")
def served(ref):
    """{dtype: the port's engine after serving the prompts}."""
    tm, npp, prompts, _, _, _ = ref
    out = {}
    for dt in LOWP:
        eng = tllm.LLMEngine(tm, npp, dtype=dt, device="cpu", **_engine_kw())
        out[dt] = (eng, _drain(eng, tllm.Sequence, prompts))
    return out


def _bytes(a):
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


def _alloc_state(alloc):
    return (sorted(alloc._free), dict(alloc._ref), list(alloc._cached),
            sorted(alloc._cacheable), alloc.num_shared, alloc.num_free)


# ------------------------------------------------------------ engine --
def test_the_jax_engines_bf16_streams_differ_from_f32(ref):
    _, _, _, engines, streams, _ = ref
    assert np.asarray(engines["bfloat16"].cache.k_pages).dtype.name == \
        "bfloat16"
    assert streams["bfloat16"] != streams["float32"]


@pytest.mark.parametrize("dtype", LOWP)
def test_engine_serves_the_jax_engines_16bit_streams(ref, served, dtype):
    eng, got = served[dtype]
    assert eng.cache.k_pages.dtype == getattr(torch, dtype)
    assert eng.cache.dtype_name == dtype
    assert got == ref[4][dtype]


def test_torch_dtype_serves_the_same_streams(ref):
    """``dtype=torch.float16`` as ``"float16"`` (bf16's torch dtype:
    tests/test_torch_engine_dtype.py)."""
    tm, npp, prompts, _, streams, _ = ref
    eng = tllm.LLMEngine(tm, npp, dtype=torch.float16, device="cpu",
                         **_engine_kw())
    assert eng.cache.k_pages.dtype == torch.float16
    assert _drain(eng, tllm.Sequence, prompts) == streams["float16"]


def _words_apart(mine, theirs):
    """|mine - theirs| in units in the last place of each 16-bit word
    (both finite, of one sign where they differ)."""
    return (mine.view(torch.int16).int()
            - theirs.view(torch.int16).int()).abs()


@pytest.mark.parametrize("dtype", LOWP)
def test_pools_equal_the_jax_engines_bit_for_bit(ref, served, dtype):
    """Carried across as raw 16-bit words (``tensor_from_numpy`` views
    the JAX side's bf16 array by its bytes): bf16 bit for bit, f16 bit
    for bit but for rare words one ulp apart (see the module
    docstring)."""
    jeng = ref[3][dtype]
    eng, _ = served[dtype]
    for mine, theirs in ((eng.cache.k_pages, jeng.cache.k_pages),
                         (eng.cache.v_pages, jeng.cache.v_pages)):
        t = tensor_from_numpy(np.asarray(theirs), "cpu")
        assert t.dtype == mine.dtype
        if dtype == "bfloat16":
            assert _bytes(t) == _bytes(mine)
            continue
        apart = _words_apart(mine, t)
        assert int(apart.max()) <= 1
        assert 200 * int((apart > 0).sum()) < int((mine != 0).sum())


@pytest.mark.parametrize("dtype", LOWP)
def test_prefix_hashes_and_allocator_state_equal_the_jax_engines(
        ref, served, dtype):
    jeng = ref[3][dtype]
    eng, _ = served[dtype]
    assert eng.cache._hash_to_block == jeng.cache._hash_to_block
    assert eng.cache._block_to_hash == jeng.cache._block_to_hash
    assert _alloc_state(eng.cache.allocator) == \
        _alloc_state(jeng.cache.allocator)
    assert eng.cache.check([])


@pytest.mark.parametrize("dtype", LOWP)
def test_server_serves_16bit_and_reports_the_pool_dtype(ref, dtype):
    tm, npp, prompts, _, streams, _ = ref
    srv = tllm.LLMServer(tm, npp, dtype=dtype, device="cpu", **_engine_kw())
    srv.start()
    try:
        got = [f.result(timeout=120).tokens
               for f in [srv.submit(p, NEW) for p in prompts]]
    finally:
        srv.shutdown()
    assert got == streams[dtype]
    st = srv.stats()
    assert st["kv_dtype"] == st["kv_cache"]["kv_dtype"] == dtype
    f32 = tllm.LLMEngine(tm, npp, device="cpu", **_engine_kw())
    assert 2 * srv.engine.cache.nbytes() == f32.cache.nbytes()


@pytest.mark.parametrize("dtype,kv_dtype,env,want", [
    ("bfloat16", "int8", None, "int8"),
    ("bfloat16", None, "float16", "float16"),
    ("float16", "float32", None, "float32"),
    ("bfloat16", "fp8", None, "float8_e4m3fn"),
])
def test_kv_dtype_falls_back_to_dtype_as_in_the_jax_engine(
        ref, monkeypatch, dtype, kv_dtype, env, want):
    """``kv_dtype`` > ``MXNET_TPU_LLM_KV_DTYPE`` > ``dtype``, fp8 by its
    short name: the pool dtype the JAX engine picks."""
    tm, npp, _, _, _, jm = ref
    if env is not None:
        monkeypatch.setenv("MXNET_TPU_LLM_KV_DTYPE", env)
    kw = dict(_engine_kw(), dtype=dtype, kv_dtype=kv_dtype)
    theirs = jllm.LLMEngine(jm, npp, **kw)
    mine = tllm.LLMEngine(tm, npp, device="cpu", **kw)
    assert mine.cache.dtype_name == np.dtype(theirs.cache.dtype).name \
        == want
    assert mine.kv_dtype_fallbacks == theirs.kv_dtype_fallbacks == 0


@pytest.mark.parametrize("dtype", ["int4", torch.float64])
def test_other_dtypes_raise(ref, dtype):
    tm, npp, _, _, _, _ = ref
    with pytest.raises(ValueError, match="bfloat16"):
        tllm.LLMEngine(tm, npp, dtype=dtype, device="cpu", **_engine_kw())


# --------------------------------------------------- model interface --
def _chunk_inputs(dtype, seed=0, Q=5):
    """A chunk step over 16-bit pools that already hold history (as
    tests/test_torch_decode_chunk.py): row 0 adds 5 tokens at 8..12, row
    1 is inactive, row 2 adds 3 tokens at 17..19 with a padded tail."""
    rng = np.random.RandomState(seed)
    L, H, Dh = CFG["num_layers"], CFG["num_heads"], 16
    pools = [rng.randn(L, 12, BS, H, Dh).astype(NP_DTYPES[dtype])
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


@pytest.mark.parametrize("dtype", LOWP)
def test_decode_chunk_then_step_over_16bit_pools_match_jax(ref, dtype):
    """A chunk, then one decode step per row on the pools it wrote: the
    logits within ``STEP_TOL``, the pools (off the null block, which
    padded tokens write in an order neither side defines) bit for bit."""
    tm, npp, _, _, _, jm = ref
    tp = params_from_numpy(npp, "cpu")
    tokens, positions, q_lens, (kp, vp), tables, kv_lens = \
        _chunk_inputs(dtype)
    jl, jk, jv = jm.decode_chunk(
        npp, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(q_lens), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(kv_lens))
    tk, tv = (tensor_from_numpy(a.copy(), "cpu") for a in (kp, vp))
    tl, _, _ = tm.decode_chunk(
        tp, *(torch.from_numpy(a) for a in (tokens, positions, q_lens)),
        tk, tv, torch.from_numpy(tables), torch.from_numpy(kv_lens))
    for i, n in enumerate(q_lens):
        np.testing.assert_allclose(tl[i, :n].numpy(),
                                   np.asarray(jl)[i, :n], atol=STEP_TOL,
                                   rtol=0)
    # one decode token per row after the chunk (row 1 starts at 1)
    step_tok = tokens[:, 0].copy()
    step_pos = kv_lens.copy()
    jl, jk, jv = jm.decode_step(
        npp, jnp.asarray(step_tok), jnp.asarray(step_pos), jk, jv,
        jnp.asarray(tables), jnp.asarray(kv_lens + 1))
    tl, _, _ = tm.decode_step(
        tp, torch.from_numpy(step_tok), torch.from_numpy(step_pos), tk, tv,
        torch.from_numpy(tables), torch.from_numpy(kv_lens + 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=STEP_TOL,
                               rtol=0)
    for mine, theirs in ((tk, jk), (tv, jv)):
        assert mine.dtype == getattr(torch, dtype)
        assert _bytes(mine[:, 1:]) == _bytes(np.asarray(theirs)[:, 1:])


# ----------------------------------------------------- plain kernels --
def _pages(rng, dtype, N, H, D):
    return rng.randn(N, BS, H, D).astype(NP_DTYPES[dtype])


def _flat_case(dtype, seed=0, H=2, D=16):
    """Packed tokens of three rows at block edges and mid-page over
    fragmented tables."""
    rng = np.random.RandomState(seed)
    tables = np.array([[9, 2, 5, 0], [7, 10, 3, 1], [4, 8, 6, 11]],
                      np.int32)
    seq_ids = np.array([0, 0, 0, 1, 1, 2, 2, 0], np.int32)
    positions = np.array([BS - 1, BS, BS + 1, 0, 31, 3, 20, 0], np.int32)
    return dict(q=rng.randn(len(seq_ids), H, D).astype(np.float32),
                k_pages=_pages(rng, dtype, 12, H, D),
                v_pages=_pages(rng, dtype, 12, H, D), block_tables=tables,
                seq_ids=seq_ids, positions=positions)


def _paged_case(dtype, chunk, seed=1, H=2, D=16):
    """Rows at kv lengths bs-1, bs+1, 3bs+2; chunk rows query their last
    (3, 1, 5) positions of Q=5."""
    rng = np.random.RandomState(seed)
    tables = np.array([[3, 0, 0, 0], [7, 2, 0, 0], [5, 1, 9, 11]],
                      np.int32)
    kv = np.array([BS - 1, BS + 1, 3 * BS + 2], np.int32)
    c = dict(k_pages=_pages(rng, dtype, 12, H, D),
             v_pages=_pages(rng, dtype, 12, H, D), block_tables=tables,
             kv_lens=kv)
    if chunk:
        c["q"] = rng.randn(3, 5, H, D).astype(np.float32)
        c["q_lens"] = np.array([3, 1, 5], np.int32)
    else:
        c["q"] = rng.randn(3, H, D).astype(np.float32)
    return c


def _with_q(c, dtype, q16):
    return dict(c, q=c["q"].astype(NP_DTYPES[dtype])) if q16 else c


def _valid(c, out):
    if "q_lens" not in c:
        return out
    return np.concatenate([out[i, :n] for i, n in enumerate(c["q_lens"])])


def _close(got, want, q16):
    got = np.asarray(got).astype(np.float32)
    want = np.asarray(want).astype(np.float32)
    tol = KERNEL_TOL
    if q16:
        tol = float(ml_dtypes.finfo(q16).eps) * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _port(fn, c):
    return fn(**{k: tensor_from_numpy(v, "cpu") for k, v in c.items()})


@pytest.mark.parametrize("q16", [False, True], ids=["q32", "q16"])
@pytest.mark.parametrize("dtype", LOWP)
@pytest.mark.parametrize("shape", ["flat", "chunk", "decode"])
def test_plain_kernels_over_16bit_pages_match_the_jax_kernels(shape, dtype,
                                                              q16):
    before = kernels.launch_counts()
    if shape == "flat":
        c = _with_q(_flat_case(dtype), dtype, q16)
        got = _port(tra.ragged_flat_attention, c)
        want = jra.ragged_flat_attention(**c, use_pallas=True,
                                         interpret=True)
    else:
        c = _with_q(_paged_case(dtype, shape == "chunk"), dtype, q16)
        got = _port(tra.ragged_paged_attention, c)
        want = jra.ragged_paged_attention(**c, use_pallas=True,
                                          interpret=True)
    assert kernels.launch_counts() == before    # plain versions on the CPU
    assert got.dtype == (getattr(torch, dtype) if q16 else torch.float32)
    assert np.asarray(want).dtype == np.dtype(c["q"].dtype)
    _close(_valid(c, got.float().numpy()),
           _valid(c, np.asarray(want).astype(np.float32)),
           NP_DTYPES[dtype] if q16 else None)


@pytest.mark.parametrize("dtype", LOWP)
def test_plain_kernels_refuse_mixed_16bit_dtypes(dtype):
    """Mixed 16-bit dtypes were refused until the kernels took every
    dtype the TPU kernels take: q of the other 16-bit dtype, and V pages
    of the other 16-bit dtype, now give what the JAX kernels give (q's
    dtype; more mixes in ``test_torch_kernel_dtypes.py``). f64 q, which
    no kernel takes, is still refused."""
    other = "float16" if dtype == "bfloat16" else "bfloat16"
    c = _with_q(_paged_case(dtype, False), other, True)
    got = _port(tra.ragged_paged_attention, c)
    want = jra.ragged_paged_attention(**c, use_pallas=True, interpret=True)
    assert got.dtype == getattr(torch, other)
    _close(got.float().numpy(), np.asarray(want).astype(np.float32),
           NP_DTYPES[other])
    c = _paged_case(dtype, False)
    c["v_pages"] = c["v_pages"].astype(NP_DTYPES[other])
    got = _port(tra.ragged_paged_attention, c)
    want = jra.ragged_paged_attention(**c, use_pallas=True, interpret=True)
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want), None)
    c["q"] = c["q"].astype(np.float64)
    with pytest.raises(TypeError, match="q has dtype"):
        _port(tra.ragged_paged_attention, c)


def test_tensor_from_numpy_views_raw_bf16_words():
    """A bf16 array that lost its dtype (``|V2``, as where ml_dtypes is
    not loaded) comes across as the same bf16 values."""
    a = np.array([1.5, -2.25, 3e-3, 65280.0], ml_dtypes.bfloat16)
    want = tensor_from_numpy(a, "cpu")
    got = tensor_from_numpy(a.view("V2"), "cpu")
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert got.tolist() == a.astype(np.float32).tolist()


def test_cache_pools_take_two_bytes_an_element():
    for dt in LOWP:
        c = PagedKVCache(2, 2, 16, BS, 9, 64, dtype=dt, device="cpu")
        assert c.k_pages.dtype == getattr(torch, dt) and not c.quantized
        assert c.nbytes() == 2 * 2 * 9 * BS * 2 * 16 * 2
        assert c.stats()["kv_dtype"] == dt

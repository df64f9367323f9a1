"""PyTorch port, the serving slice: ``TinyDecoder`` / ``LLMEngine`` /
``LLMServer`` of ``mxnet_tpu_torch`` against the JAX package's model
and its greedy oracle, on the same seeded weights (one model pair per
module, on the CPU, where every kernel takes its plain version).

Tolerances, each with its reason:

- ``FWD_TOL = 1e-5`` — dense forward logits / K / V: the same f32 math,
  matmul and softmax sums in another order, two layers deep.
- ``STEP_TOL = 1e-4`` — ``decode_flat`` logits in all three variants
  (f32; int8 KV + int8 weights; fp8 KV + fp8 weights): the paged
  attention and the quantized matmuls reorder sums too, and the
  quantized KV is rounded from values that already differ in the last
  bits (no rounding boundary is crossed for this pinned input).
- Greedy streams are held token for token (the argmax is exact).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu.serving import llm as jllm  # noqa: E402
from mxnet_tpu_torch.convert import params_from_numpy  # noqa: E402
from mxnet_tpu_torch.serving import llm as tllm  # noqa: E402
from mxnet_tpu_torch.serving.llm.kv_cache import PagedKVCache  # noqa: E402

torch.set_num_threads(2)

FWD_TOL = 1e-5
STEP_TOL = 1e-4
CFG = dict(vocab_size=48, d_model=32, num_layers=2, num_heads=2,
           d_ff=64, max_context=64)
BS = 8


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model, numpy params, port params)."""
    jm = jllm.TinyDecoder(jllm.DecoderConfig(**CFG))
    tm = tllm.TinyDecoder(tllm.DecoderConfig(**CFG), device="cpu")
    npp = jm.init_params(seed=0)
    return jm, tm, npp, params_from_numpy(npp, "cpu")


@pytest.fixture(scope="module")
def oracle(pair):
    """JAX greedy oracle, memoized per (prompt, n)."""
    jm, _, npp, _ = pair
    memo = {}

    def run(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = jllm.greedy_decode_reference(jm, npp, prompt, n)
        return memo[key]
    return run


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG["vocab_size"], size=n).tolist()
            for n in lens]


def test_init_params_numpy_identical(pair):
    jm, tm, npp, _ = pair
    mine = tllm.quant.flatten_params(tm.init_params_numpy(0))
    from mxnet_tpu.deploy import flatten_params
    theirs = flatten_params(npp)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert np.array_equal(mine[k], theirs[k]), k


def test_forward_matches_jax(pair):
    jm, tm, npp, tp = pair
    toks = np.asarray(_prompts(1, [20, 20]), np.int32)
    jl, jk, jv = jm.forward(npp, jnp.asarray(toks))
    tl, tk, tv = tm.forward(tp, torch.from_numpy(toks))
    for a, b in ((tl, jl), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=FWD_TOL, rtol=0)


def _packed(seed):
    """A mixed packed batch: three sequences written from position 0
    (lengths bs-1, bs+1, 2*bs+3, fragmented tables) and two padded
    tokens."""
    lens = (BS - 1, BS + 1, 2 * BS + 3)
    seqs = _prompts(seed, lens)
    tables = np.zeros((4, 4), np.int32)
    tables[0, :1] = [5]
    tables[1, :2] = [2, 9]
    tables[2, :3] = [11, 3, 7]
    tok, pos, sid = [], [], []
    for i, s in enumerate(seqs):
        tok += s
        pos += range(len(s))
        sid += [i] * len(s)
    n = len(tok)
    tok += [0, 0]
    pos += [0, 0]
    sid += [0, 0]
    valid = [1] * n + [0, 0]
    arr = [np.asarray(a, np.int32) for a in (tok, pos, sid, valid)]
    return arr + [tables], n


@pytest.mark.parametrize("variant", ["float32", "int8", "fp8"])
def test_decode_flat_matches_jax(pair, variant):
    jm, tm, npp, tp = pair
    (tok, pos, sid, valid, tables), n = _packed(2)
    L, H, Dh = CFG["num_layers"], CFG["num_heads"], 16
    shape = (L, 12, BS, H, Dh)
    if variant == "float32":
        jparams, jws, tparams, tws = npp, None, tp, None
        jdt = np.float32
    else:
        jqw = jllm.quantize_weights(npp, dtype=variant)
        tqw = params_from_numpy(jqw, "cpu")
        jparams, jws, tparams, tws = jqw.params, jqw.scales, \
            tqw.params, tqw.scales
        jdt = np.int8 if variant == "int8" else np.dtype(
            "float8_e4m3fn")
    jkw = {}
    if variant != "float32":
        jkw = dict(k_scales=jnp.ones(shape[:-1], jnp.float32),
                   v_scales=jnp.ones(shape[:-1], jnp.float32))
    out = jm.decode_flat(
        jparams, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(sid),
        jnp.asarray(valid), jnp.zeros(shape, jdt), jnp.zeros(shape, jdt),
        jnp.asarray(tables), w_scales=jws, **jkw)
    cache = PagedKVCache(L, H, Dh, BS, 12, CFG["max_context"],
                         dtype={"fp8": "float8_e4m3fn"}.get(variant, variant),
                         device="cpu")
    kw = {} if tws is None else {"w_scales": tws}
    if cache.quantized:
        kw.update(k_scales=cache.k_scales, v_scales=cache.v_scales)
    got = tm.decode_flat(tparams, *(torch.from_numpy(a) for a in
                                    (tok, pos, sid, valid)),
                         cache.k_pages, cache.v_pages,
                         torch.from_numpy(tables), **kw)
    np.testing.assert_allclose(got[:n].numpy(), np.asarray(out[0])[:n],
                               atol=STEP_TOL, rtol=0)
    # the pages every valid token wrote hold the same K/V
    live = [b for b in (5, 2, 9, 11, 3, 7)]
    kp = cache.k_pages[:, live].float()
    jk = np.asarray(out[1])[:, live].astype(np.float32)
    if cache.quantized:
        kp = kp * cache.k_scales[:, live][..., None]
        jk = jk * np.asarray(out[3])[:, live][..., None]
    np.testing.assert_allclose(kp.numpy(), jk, atol=STEP_TOL, rtol=0)


def test_greedy_decode_reference_matches_jax(pair, oracle):
    _, tm, _, tp = pair
    for prompt in _prompts(3, [1, 9, 30]):
        assert tllm.greedy_decode_reference(tm, tp, prompt, 10) == \
            oracle(prompt, 10)


def _drain(engine, seqs, max_steps=2000):
    for s in seqs:
        engine.add(s)
    for _ in range(max_steps):
        if not engine.has_work():
            break
        engine.step()
    assert not engine.has_work()
    return engine.pop_finished()


def test_engine_streams_match_jax_oracle_under_preemption(pair, oracle):
    """Mixed prompt lengths through a pool too small for all of them:
    sequences are preempted and resumed, and every greedy stream still
    equals the JAX oracle token for token."""
    _, tm, npp, _ = pair
    stats = tllm.LLMStats(server="t-preempt")
    eng = tllm.LLMEngine(tm, npp, max_seqs=4, block_size=BS,
                         num_blocks=13, prefill_chunk=8, device="cpu",
                         stats=stats)
    prompts = _prompts(4, [5, 17, 24, 31, 8])
    seqs = [tllm.Sequence(p, 16) for p in prompts]
    done = _drain(eng, seqs)
    assert len(done) == len(seqs)
    assert stats.snapshot()["preemptions"] > 0
    for p, s in zip(prompts, seqs):
        assert s.output_tokens() == oracle(p, 16)
    assert eng.cache.check([]) and eng.cache.allocator.num_used == 0


def test_engine_prefix_hit_and_copy_on_write(pair, oracle):
    """A block-aligned prompt joins while an identical one is live: its
    prefix is served from the cache, the recomputed last token
    copy-on-writes the shared block, and both streams equal the
    oracle."""
    _, tm, npp, _ = pair
    eng = tllm.LLMEngine(tm, npp, max_seqs=2, block_size=BS,
                         prefill_chunk=8, device="cpu")
    prompt = _prompts(5, [2 * BS])[0]
    a = tllm.Sequence(prompt, 12)
    eng.add(a)
    while not a.generated:
        eng.step()
    b = tllm.Sequence(prompt, 12)
    _drain(eng, [b])
    assert eng.prefix_hits == 1 and eng.prefill_tokens_saved == 2 * BS - 1
    assert eng.cache.cow_count == 1
    assert a.output_tokens() == b.output_tokens() == oracle(prompt, 12)
    assert eng.cache.check([])


def test_quantized_engine_agrees_top1_with_jax_oracle():
    """int8 KV + int8 weights on the JAX suite's pinned int8 config
    (tests/test_kv_quant.py): greedy streams agree top-1 with the f32
    JAX oracle, token for token."""
    cfg = dict(vocab_size=17, d_model=16, num_layers=2, num_heads=2,
               d_ff=32, max_context=32)
    jm = jllm.TinyDecoder(jllm.DecoderConfig(**cfg))
    npp = jm.init_params(seed=0)
    tm = tllm.TinyDecoder(tllm.DecoderConfig(**cfg), device="cpu")
    eng = tllm.LLMEngine(tm, npp, max_seqs=3, block_size=8,
                         prefill_chunk=8, kv_dtype="int8",
                         weight_dtype="int8", device="cpu")
    eng.warmup()
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, 17, size=n).tolist() for n in (3, 9, 14)]
    seqs = [tllm.Sequence(p, 8) for p in prompts]
    _drain(eng, seqs)
    for p, s in zip(prompts, seqs):
        assert s.output_tokens() == jllm.greedy_decode_reference(
            jm, npp, p, 8)


def test_server_serves_mixed_traffic(pair, oracle):
    """Greedy and sampled requests through LLMServer: greedy streams
    equal the oracle, a sampled stream repeats exactly under the same
    seed, nothing is built after warmup, every block comes back."""
    _, tm, npp, _ = pair
    srv = tllm.LLMServer(tm, npp, max_seqs=4, block_size=BS,
                         prefill_chunk=8, device="cpu")
    srv.warmup()
    builds = srv.stats()["compiles"]
    srv.start()
    prompts = _prompts(7, [4, 12, 21])
    samp = dict(temperature=0.9, top_p=0.9, seed=11)
    futs = [srv.submit(p, 10) for p in prompts]
    futs += [srv.submit(prompts[1], 10, sampling=samp) for _ in range(2)]
    res = [f.result(timeout=120) for f in futs]
    srv.shutdown()
    for p, r in zip(prompts, res):
        assert r.tokens == oracle(p, 10)
    assert res[3].tokens == res[4].tokens
    st = srv.stats()
    assert st["compiles"] == builds
    assert st["requests_completed"] == 5 and st["ttft_ms"]["p50"] > 0
    assert st["kv_cache"]["blocks_used"] == 0


def test_server_cancel_and_shutdown_resolve_typed(pair):
    _, tm, npp, _ = pair
    srv = tllm.LLMServer(tm, npp, max_seqs=2, block_size=BS,
                         device="cpu").start()
    fut = srv.submit(_prompts(8, [6])[0], 40)
    srv.cancel(fut)
    with pytest.raises(tllm.DeadlineExceededError):
        fut.result(timeout=60)
    late = srv.submit(_prompts(9, [6])[0], 40)
    srv.shutdown(drain=False)
    assert late.done()
    with pytest.raises(tllm.SequenceEvictedError):
        late.result()
    assert srv.engine.cache.allocator.num_used == 0


@pytest.mark.parametrize("entry", ["TinyDecoder", "LLMEngine",
                                   "LLMServer"])
def test_entry_points_default_to_cuda(pair, entry):
    """Without ``device=`` every entry point asks for the card, and
    raises when CUDA is absent."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tm, npp, _ = pair
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "TinyDecoder":
            tllm.TinyDecoder(tllm.DecoderConfig(**CFG))
        else:
            getattr(tllm, entry)(tm, npp)


@pytest.mark.parametrize("kw", [{"adapter_bank": "mis-shaped"},
                                {"mesh": "tp=2"}])
def test_unported_features_raise(pair, kw):
    """A mesh is not ported yet (``NotImplementedError`` naming ROADMAP);
    an adapter bank is, and one shaped for another model raises
    ``ValueError`` naming the layers, as the reference does."""
    _, tm, npp, _ = pair
    if "adapter_bank" in kw:
        from mxnet_tpu_torch.serving.adapters import AdapterBank
        bank = AdapterBank(tm.num_layers + 1, tm.config.d_model,
                           max_adapters=1, device="cpu")
        with pytest.raises(ValueError, match="layers"):
            tllm.LLMEngine(tm, npp, device="cpu", adapter_bank=bank)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tllm.LLMEngine(tm, npp, device="cpu", **kw)

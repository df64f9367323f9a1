"""PyTorch port, speculative decoding: ``LLMEngine`` / ``LLMServer`` of
``mxnet_tpu_torch`` with a draft model (``draft_model=``,
``draft_params=``, ``spec_k=``, ``draft_weight_dtype=``) against the JAX
package's engine and its greedy oracle, on the CPU, where every kernel
takes its plain version and the programs run eagerly on their static
buffers.

One port model and one JAX model per module (the JAX package's widths
of ``tests/test_torch_llm.py``), ``max_seqs=2``, ``spec_k=2``; the draft
is the target truncated to one layer, sharing its parameters (as the
reference's serving bench builds its draft). Greedy streams are held
token for token (the argmax is exact at these widths). Sampled streams
are held to themselves under the same seeds: the two packages' noise
generators differ (Philox against threefry), so sampled streams are not
compared across packages.
``tests/test_torch_spec_programs.py`` holds the verify step and the
draft round one rung at a time.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

from mxnet_tpu.serving import llm as jllm  # noqa: E402
from mxnet_tpu.serving.llm.metrics import LLMStats as JStats  # noqa: E402
from mxnet_tpu_torch import kernels  # noqa: E402
from mxnet_tpu_torch.serving import llm as tllm  # noqa: E402
from mxnet_tpu_torch.serving.llm.metrics import LLMStats  # noqa: E402

torch.set_num_threads(2)

CFG = dict(vocab_size=48, d_model=32, num_layers=2, num_heads=2,
           d_ff=64, max_context=64)
BS, S, K = 8, 2, 2


def _truncated(params, n):
    return dict(params, layers=list(params["layers"][:n]))


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX draft, port model, port draft, numpy params,
    numpy draft params)."""
    jm = jllm.TinyDecoder(jllm.DecoderConfig(**CFG))
    jd = jllm.TinyDecoder(jllm.DecoderConfig(**dict(CFG, num_layers=1)))
    tm = tllm.TinyDecoder(tllm.DecoderConfig(**CFG), device="cpu")
    td = tllm.TinyDecoder(tllm.DecoderConfig(**dict(CFG, num_layers=1)),
                          device="cpu")
    npp = jm.init_params(seed=0)
    return jm, jd, tm, td, npp, _truncated(npp, 1)


@pytest.fixture(scope="module")
def oracle(pair):
    """The JAX greedy oracle, memoized per (prompt, n)."""
    jm, _, _, _, npp, _ = pair
    memo = {}

    def run(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = list(jllm.greedy_decode_reference(jm, npp, prompt,
                                                          n))
        return memo[key]
    return run


def _engine(pair, draft=True, **kw):
    _, _, tm, td, npp, dp = pair
    kw.setdefault("max_seqs", S)
    kw.setdefault("block_size", BS)
    if draft:
        kw.setdefault("draft_model", td)
        kw.setdefault("draft_params", dp)
        kw.setdefault("spec_k", K)
    return tllm.LLMEngine(tm, npp, device="cpu", **kw)


def _cases(seed, n=6):
    """A ragged mix of prompts (1..24 tokens) and lengths (1..13)."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, CFG["vocab_size"],
                         size=int(rng.randint(1, 25))).tolist(),
             int(rng.randint(1, 14))) for _ in range(n)]


def _drain(eng, cases, sampling=None, check_pool=False):
    seqs = [tllm.Sequence(p, n, sampling=sampling) for p, n in cases]
    for s in seqs:
        eng.add(s)
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
        assert steps < 2000
        if check_pool:
            eng.cache.check(live_block_ids=[
                s.block_ids for s in eng.scheduler.running()])
    eng.pop_finished()
    return [s.output_tokens() for s in seqs]


# ------------------------------------------------------------ streams --
def test_spec_greedy_streams_match_the_oracle_and_plain_engine(pair,
                                                               oracle):
    """A ragged mixed batch of 6 prompts: the speculative engine's greedy
    streams equal the JAX oracle's and the port's no-draft engine's, with
    proposals accepted and fewer decode steps than tokens."""
    stats = LLMStats()
    eng = _engine(pair, stats=stats)
    warm = eng.warmup()
    assert any(k.startswith("draft_t") for k in warm)
    assert any(k.startswith("step_t") for k in warm)
    cases = _cases(9)
    got = _drain(eng, cases)
    assert got == [oracle(p, n) for p, n in cases]
    assert got == _drain(_engine(pair, draft=False), cases)
    snap = stats.snapshot()
    assert snap["spec_accepted"] > 0
    assert snap["decode_steps"] < snap["tokens_generated"]
    assert snap["spec_accept_rate"] == pytest.approx(
        snap["spec_accepted"] / snap["spec_proposed"])
    assert eng.cache.allocator.num_used == 0
    eng.cache.check(live_block_ids=[])


def test_spec_lockstep_with_the_jax_engine(pair):
    """The port's speculative engine and the JAX package's, given the
    same model, draft and params and the same traffic (6 ragged prompts
    and a prefix-cache hit on the first one's two full blocks), step in
    lockstep: after every step the event kinds, each sequence's
    ``generated``, ``seq_len``, ``draft_len`` and ``block_ids``, the
    allocator's free count and refcounts, and the proposed and accepted
    counts are identical."""
    jm, jd, _, _, npp, dp = pair
    js, ts = JStats(server="spec_lockstep_t"), LLMStats()
    je = jllm.LLMEngine(jm, npp, max_seqs=S, block_size=BS, draft_model=jd,
                        draft_params=dp, spec_k=K, stats=js)
    te = _engine(pair, stats=ts)
    cases = _cases(9)
    cases.append((cases[0][0][:2 * BS] + [3, 4, 5], 6))
    jseqs = [jllm.Sequence(p, n) for p, n in cases]
    tseqs = [tllm.Sequence(p, n) for p, n in cases]
    for a, b in zip(jseqs, tseqs):
        je.add(a)
        te.add(b)
    steps = 0
    while je.has_work() or te.has_work():
        ev_j, ev_t = je.step(), te.step()
        steps += 1
        assert steps < 500
        assert [k for k, _ in ev_j] == [k for k, _ in ev_t], steps
        for a, b in zip(jseqs, tseqs):
            assert (a.generated, a.seq_len, a.draft_len, a.block_ids) == \
                (b.generated, b.seq_len, b.draft_len, b.block_ids), \
                (steps, cases.index((a.prompt, a.max_new_tokens)))
        ja, ta = je.cache.allocator, te.cache.allocator
        assert ja.num_free == ta.num_free
        assert ja._ref == ta._ref
        sj, st = js.snapshot(), ts.snapshot()
        assert (sj["spec_proposed"], sj["spec_accepted"]) == \
            (st["spec_proposed"], st["spec_accepted"])
    assert ts.snapshot()["spec_accepted"] > 0
    assert te.prefix_hits == je.prefix_hits >= 1


def test_self_draft_accepts_almost_every_proposal(pair, oracle):
    """The target as its own draft: the same streams, and all but a few
    proposals accepted (a proposal can only lose to a near tie between
    the draft's pack and the verify's)."""
    _, _, tm, _, npp, _ = pair
    stats = LLMStats()
    eng = _engine(pair, draft_model=tm, draft_params=npp, stats=stats)
    cases = _cases(4, n=4)
    assert _drain(eng, cases) == [oracle(p, n) for p, n in cases]
    snap = stats.snapshot()
    assert snap["spec_proposed"] > 0
    assert snap["spec_accepted"] >= 0.95 * snap["spec_proposed"]


def test_adversarial_draft_rolls_back_through_the_allocator(pair,
                                                            oracle):
    """A draft of random weights (most proposals rejected) under
    sustained speculation: the pool's accounting holds after every step,
    the pool ends empty, proposals are rejected, and the greedy streams
    still equal the oracle's."""
    bad = tllm.TinyDecoder(tllm.DecoderConfig(
        vocab_size=CFG["vocab_size"], d_model=8, num_layers=1, num_heads=1,
        d_ff=16, max_context=CFG["max_context"]), device="cpu")
    stats = LLMStats()
    eng = _engine(pair, draft_model=bad,
                  draft_params=bad.init_params_numpy(99), stats=stats)
    cases = [([1 + i, 2, 3], 20) for i in range(4)]
    got = _drain(eng, cases, check_pool=True)
    snap = stats.snapshot()
    assert 0 < snap["spec_proposed"]
    assert snap["spec_accepted"] < snap["spec_proposed"]
    assert eng.cache.allocator.num_used == 0
    assert got == [oracle(p, n) for p, n in cases]


@pytest.mark.parametrize("sampling", [
    dict(temperature=0.8, seed=3),
    dict(temperature=1.0, top_k=5, seed=11),
    dict(temperature=0.7, top_p=0.9, seed=5)],
    ids=["temperature", "top_k", "top_p"])
def test_sampled_spec_streams_repeat_under_their_seeds(pair, sampling):
    """Two speculative engines given the same seeds produce the same
    sampled streams, with proposals made and verified on the sampled
    variants (the draft's probabilities kept on the device)."""
    sp = tllm.SamplingParams(**sampling)
    cases = _cases(21, n=4)
    runs = []
    for _ in range(2):
        stats = LLMStats()
        eng = _engine(pair, stats=stats)
        runs.append(_drain(eng, cases, sampling=sp))
        assert stats.snapshot()["spec_proposed"] > 0
        assert any(key[2] for key in eng._draft_programs)
        assert any(key[2] for key in eng._programs)
    assert runs[0] == runs[1]
    assert all(0 <= t < CFG["vocab_size"] for r in runs[0] for t in r)


def test_verify_reads_each_sampled_rounds_probabilities(pair):
    """Each sampled draft round's ``[S, V]`` probabilities reach the
    verify in their round's column of the draft-probability tensor (the
    copy stays on the device); greedy rounds copy nothing."""
    eng = _engine(pair)
    rounds, seen = [], []
    draft_dispatch, dispatch = eng._draft_dispatch, eng._dispatch

    def spy_draft(rows, feeds, counters, r):
        tok = draft_dispatch(rows, feeds, counters, r)
        sampled = any(s.sampling.temperature > 0 for s in feeds)
        rounds.append((r, sampled, eng._draft_round_probs.clone()))
        return tok

    def spy_verify(rows, plans):
        seen.append((list(rounds), eng._draft_probs.clone()))
        rounds.clear()
        return dispatch(rows, plans)
    eng._draft_dispatch, eng._dispatch = spy_draft, spy_verify
    _drain(eng, _cases(12, n=3),
           sampling=tllm.SamplingParams(temperature=0.9, seed=8))
    checked = 0
    for rs, probs in seen:
        for r, sampled, p in rs:
            assert sampled
            assert torch.equal(probs[:, r], p)
            checked += 1
    assert checked >= 4
    assert all(torch.allclose(p.sum(-1), torch.ones(S))
               for rs, _ in seen for _, _, p in rs)


def test_spec_with_the_prefix_cache(pair, oracle):
    """Speculation over prefix-cache hits: a hit's catch-up feeds
    rebuild the draft's KV for the hit tokens, greedy streams equal the
    oracle's, and a copy-on-write of a shared block copies the draft's
    pools as well as the target's."""
    eng = _engine(pair, max_seqs=4, prefill_chunk=4)
    copies = {"target": [], "draft": []}
    for name, cache in (("target", eng.cache), ("draft", eng.draft_cache)):
        orig = cache.copy_block

        def spy(src, dst, _orig=orig, _name=name):
            copies[_name].append((src, dst))
            return _orig(src, dst)
        cache.copy_block = spy
    rng = np.random.RandomState(9)
    prefix = rng.randint(0, CFG["vocab_size"], size=2 * BS).tolist()
    cases = [(prefix + rng.randint(0, 48, size=3).tolist(), 6),
             (prefix + rng.randint(0, 48, size=5).tolist(), 5),
             (list(prefix), 7),          # a block-aligned full hit: COW
             (prefix[:BS] + [1, 2], 4)]
    got = _drain(eng, cases[:1])
    got += _drain(eng, cases[1:])
    assert got == [oracle(p, n) for p, n in cases]
    assert eng.prefix_hits >= 3
    assert copies["target"] and copies["draft"] == copies["target"]
    assert eng.cache.allocator.num_used == 0
    eng.cache.check(live_block_ids=[])


def test_cow_copies_the_draft_row(pair):
    """``_cow_block`` on a shared block: the private copy's row holds
    the original's in every pool, the draft's included."""
    eng = _engine(pair, kv_dtype="int8")
    a = eng.cache.allocator
    old = a.alloc(1)[0]
    a.ref(old)
    g = torch.Generator().manual_seed(0)
    for cache in (eng.cache, eng.draft_cache):
        for pool in cache.pools():
            pool[:, old] = torch.randint(-100, 100, pool[:, old].shape,
                                         generator=g).to(pool.dtype)
    seq = tllm.Sequence([1, 2, 3], 2)
    seq.block_ids = [old]
    eng._cow_block(seq, 0)
    new = seq.block_ids[0]
    assert new != old and a.refcount(old) == 1 and a.refcount(new) == 1
    for cache in (eng.cache, eng.draft_cache):
        for pool in cache.pools():
            assert torch.equal(pool[:, new], pool[:, old])


def test_degraded_draft_step_keeps_the_stream(pair, oracle):
    """A draft whose ``decode_flat`` raises on one call: that step
    degrades to plain decode (``spec_degraded`` 1), the stream is
    unchanged, and speculation resumes afterwards."""
    _, _, _, td, _, dp = pair
    flaky = tllm.TinyDecoder(td.config, device="cpu")
    calls = []
    step = flaky.decode_flat

    def decode_flat(*a, **k):
        calls.append(1)
        if len(calls) == 6:
            raise RuntimeError("injected draft failure")
        return step(*a, **k)
    flaky.decode_flat = decode_flat
    stats = LLMStats()
    eng = _engine(pair, draft_model=flaky, stats=stats)
    seq = tllm.Sequence([5, 6, 7, 8], 16)
    eng.add(seq)
    proposed = []
    while eng.has_work():
        eng.step()
        proposed.append(stats.snapshot()["spec_proposed"])
    snap = stats.snapshot()
    assert snap["spec_degraded"] == 1
    assert seq.output_tokens() == oracle([5, 6, 7, 8], 16)
    assert len(calls) > 6
    # a proposal was verified after the degraded step
    at = next(i for i, n in enumerate(proposed)
              if i and n == proposed[i - 1])
    assert proposed[-1] > proposed[at]


def test_capture_failure_in_a_draft_round_is_not_degraded(pair):
    """A draft program that fails to capture (or to build a kernel in
    its warm run) raises out of ``step()``: the degrade path catches
    dispatch failures only."""
    eng = _engine(pair)

    def fail(*a):
        raise kernels.CaptureError("CUDA graph capture of the draft rung "
                                   "t4mb4_greedy failed")
    eng._draft_program = fail
    eng.add(tllm.Sequence([1, 2, 3], 4))
    with pytest.raises(kernels.CaptureError, match="draft rung"):
        eng.step()


# ------------------------------------------- weights and KV dtypes --
@pytest.mark.parametrize("wdt", ["int8", "fp8"])
def test_quantized_draft_keeps_greedy_streams(pair, oracle, wdt):
    """An int8 or fp8 draft (``draft_weight_dtype``) under a f32 target:
    the greedy streams equal target-only decoding; the draft's matmuls
    take the quantized path."""
    eng = _engine(pair, draft_weight_dtype=wdt, max_seqs=4,
                  prefill_chunk=8)
    assert eng.draft_weight_quantized and not eng.weight_quantized
    assert eng.draft_weight_dtype == {"int8": "int8",
                                      "fp8": "float8_e4m3fn"}[wdt]
    assert eng.draft_w_scales and eng.w_scales is None
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12, 13], [14, 15],
               list(range(1, 15))]
    got = _drain(eng, [(p, 8) for p in prompts])
    assert got == [oracle(p, 8) for p in prompts]
    eng.cache.check([])


@pytest.mark.parametrize("kw", [dict(kv_dtype="int8"),
                                dict(dtype="bfloat16")],
                         ids=["int8_kv", "bf16_pools"])
def test_spec_over_quantized_and_16bit_pools(pair, kw):
    """With int8 KV or bf16 pools the draft's pools take the target's
    dtype, and the speculative greedy streams equal the no-draft
    engine's over the same pools."""
    eng = _engine(pair, **kw)
    assert eng.draft_cache.dtype == eng.cache.dtype
    assert eng.draft_cache.quantized == eng.cache.quantized
    cases = _cases(9)
    assert _drain(eng, cases) == _drain(_engine(pair, draft=False, **kw),
                                        cases)


# --------------------------------------------------------- config --
def test_spec_validation(pair):
    """A vocab mismatch, a draft shorter than the engine's context and
    a negative ``spec_k`` each raise ``ValueError``."""
    _, _, _, _, npp, _ = pair
    other = tllm.TinyDecoder(tllm.DecoderConfig(
        **dict(CFG, vocab_size=40, num_layers=1)), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        _engine(pair, draft_model=other,
                draft_params=other.init_params_numpy(0))
    short = tllm.TinyDecoder(tllm.DecoderConfig(
        **dict(CFG, max_context=32, num_layers=1)), device="cpu")
    with pytest.raises(ValueError, match="max_context"):
        _engine(pair, draft_model=short,
                draft_params=short.init_params_numpy(0))
    with pytest.raises(ValueError, match="spec_k"):
        _engine(pair, spec_k=-1)
    with pytest.raises(ValueError, match="spec_k"):
        _engine(pair, draft=False, spec_k=-1)


def test_spec_defaults_and_env(pair, monkeypatch):
    """``spec_k`` defaults to 3 with a draft and 0 without;
    ``MXNET_TPU_LLM_SPEC_K`` and ``MXNET_TPU_LLM_DRAFT_WEIGHT_DTYPE``
    apply when the arguments are absent; ``spec_k=0`` turns the draft
    off; the ladders follow ``spec_k``."""
    monkeypatch.delenv("MXNET_TPU_LLM_SPEC_K", raising=False)
    monkeypatch.delenv("MXNET_TPU_LLM_DRAFT_WEIGHT_DTYPE", raising=False)
    eng = _engine(pair, spec_k=None)
    assert eng.spec_k == 3 and eng.draft_weight_dtype == "float32"
    assert eng.q_tokens == 16
    plain = _engine(pair, draft=False)
    assert plain.spec_k == 0 and plain.draft_cache is None
    assert plain.programs()["draft_t_buckets"] == []
    off = _engine(pair, spec_k=0)
    assert off.spec_k == 0 and off.draft_model is None
    monkeypatch.setenv("MXNET_TPU_LLM_SPEC_K", "1")
    monkeypatch.setenv("MXNET_TPU_LLM_DRAFT_WEIGHT_DTYPE", "int8")
    eng = _engine(pair, spec_k=None, max_seqs=8, prefill_chunk=16)
    assert eng.spec_k == 1 and eng.draft_weight_dtype == "int8"
    assert eng._t_buckets == [16, 30, 44, 128]
    assert eng._draft_t_buckets == [16, 30, 44, 128]
    assert _engine(pair, spec_k=2, max_seqs=8, prefill_chunk=16) \
        ._t_buckets == [24, 37, 50, 128]


def test_spec_ladders_match_the_reference(pair):
    """The target's and the draft's packed-length ladders and the table
    widths are the JAX engine's at the same configuration."""
    jm, jd, _, _, npp, dp = pair
    for kw in (dict(max_seqs=2, spec_k=2),
               dict(max_seqs=4, spec_k=3, prefill_chunk=4),
               dict(max_seqs=8, spec_k=2, prefill_chunk=16)):
        je = jllm.LLMEngine(jm, npp, block_size=BS, draft_model=jd,
                            draft_params=dp, **kw)
        te = _engine(pair, **kw)
        assert te._t_buckets == je._t_buckets
        assert te._draft_t_buckets == je._draft_t_buckets
        assert te._mb_widths == je._mb_widths
        assert te.q_tokens == je.q_tokens


def test_warmup_builds_every_draft_rung_and_nothing_after(pair):
    """``warmup()`` builds every rung of both ladders, times each under
    the reference's keys, and after it speculative traffic (greedy and
    sampled) builds no program; ``programs()`` reports the draft ladder
    and counts every program run."""
    eng = _engine(pair)
    warm = eng.warmup()
    progs = eng.programs()
    n_mb = len(progs["mb_widths"])
    assert progs["step_variants"] == 2 * len(progs["t_buckets"]) * n_mb
    assert progs["draft_variants"] == \
        2 * len(progs["draft_t_buckets"]) * n_mb
    assert sorted(k for k in warm if k.startswith("draft_")) == sorted(
        f"draft_t{t}mb{mb}_{v}" for t in progs["draft_t_buckets"]
        for mb in progs["mb_widths"] for v in ("greedy", "sampled"))
    assert "cow_copy" in warm
    built = (dict(eng._programs), dict(eng._draft_programs))
    _drain(eng, _cases(9)[:3])
    _drain(eng, _cases(10)[:3],
           sampling=tllm.SamplingParams(temperature=0.9, seed=1))
    assert (eng._programs, eng._draft_programs) == built
    after = eng.programs()
    assert after["draft_dispatches"] > progs["draft_dispatches"]
    assert after["dispatches"] - progs["dispatches"] > \
        after["draft_dispatches"] - progs["draft_dispatches"]


def test_server_serves_speculatively(pair, oracle):
    """``LLMServer`` with a draft serves greedy and sampled requests;
    its ``stats()`` carries ``spec_k``, ``draft_weight_dtype`` and the
    ``spec_*`` counts."""
    _, _, tm, td, npp, dp = pair
    srv = tllm.LLMServer(tm, npp, max_seqs=S, block_size=BS,
                         draft_model=td, draft_params=dp, spec_k=K,
                         draft_weight_dtype="int8", device="cpu")
    srv.warmup()
    srv.start()
    cases = _cases(9, n=3)
    try:
        futs = [srv.submit(p, n) for p, n in cases]
        futs.append(srv.submit(cases[0][0], 5,
                               sampling=dict(temperature=0.8, seed=2)))
        got = [f.result(timeout=120).tokens for f in futs]
    finally:
        srv.shutdown()
    assert got[:3] == [oracle(p, n) for p, n in cases]
    assert len(got[3]) == 5
    st = srv.stats()
    assert st["spec_k"] == K and st["q_tokens"] == 16
    assert st["draft_weight_dtype"] == "int8"
    assert st["spec_proposed"] > 0 and st["spec_degraded"] == 0
    assert 0 < st["spec_accept_rate"] <= 1
    assert st["spec_accepted"] <= st["spec_proposed"]
    assert st["programs"]["draft_dispatches"] > 0


def test_adapter_bank_and_mesh_still_raise(pair):
    """With a draft too: a mesh, not ported yet, still refuses; an
    adapter bank shaped for another model raises ``ValueError`` naming
    the layers, as the reference does."""
    from mxnet_tpu_torch.serving.adapters import AdapterBank
    _, _, tm, _, _, _ = pair
    bank = AdapterBank(tm.num_layers + 1, tm.config.d_model,
                       max_adapters=1, device="cpu")
    with pytest.raises(ValueError, match="layers"):
        _engine(pair, adapter_bank=bank)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _engine(pair, mesh="tp=2")

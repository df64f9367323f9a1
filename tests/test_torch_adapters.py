"""PyTorch port, multi-LoRA serving: ``AdapterBank`` and
``LLMEngine(adapter_bank=)`` / ``LLMServer.submit(adapter=)`` of
``mxnet_tpu_torch`` against the JAX package's bank and engine on the
same numpy factors and traffic, on the CPU (every kernel's plain
version; the step programs run eagerly on their static buffers).

Mirrors ``tests/test_adapters.py`` at its shapes (vocab 17, block 8,
context 32, 2 layers, d_model 16; a bank of 4 adapters of page rank 4):

- a mixed-adapter batch (three adapters and base-model rows, ragged
  prompts, staggered admission) in lockstep with the JAX engine: after
  every step the event kinds, each sequence's tokens, length and block
  ids, the allocator's free count and refcounts, the salted prefix
  hashes and the banks' stats and page ids are identical, and every
  stream equals the per-adapter oracle (JAX's);
- the prefix cache namespaced by the pinned ``name@version``;
- adapter churn (publish, serve, evict, republish a live name) builds,
  captures and adds no program;
- an unknown adapter poisons its sequence and leaks nothing; ``submit
  (adapter=)`` without a bank raises, an unknown name raises typed;
- the bank's accounting under a randomized publish / acquire / release /
  evict storm against the reference test's shadow model;
- speculative decoding under mixed adapters (the base draft proposes,
  the adapter-bearing target verifies);
- a resident cold adapter whose ``x @ A`` overflows leaves every other
  row's stream the JAX engine's.

One warmed JAX engine and one warmed port engine, shared by the module.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

from mxnet_tpu.serving import llm as jllm  # noqa: E402
from mxnet_tpu.serving.adapters import AdapterBank as JBank  # noqa: E402
from mxnet_tpu_torch.serving import llm as tllm  # noqa: E402
from mxnet_tpu_torch.serving.adapters import (  # noqa: E402
    AdapterBank, AdapterAccountingError, AdapterRegistry,
    NoFreeAdapterPagesError, UnknownAdapterError)
from mxnet_tpu_torch.serving.llm.metrics import LLMStats  # noqa: E402
from mxnet_tpu_torch.serving.telemetry import compile_count  # noqa: E402

torch.set_num_threads(2)

VOCAB, BS, CTX, L, D = 17, 8, 32, 2, 16
CFG = dict(vocab_size=VOCAB, d_model=D, num_layers=L, num_heads=2, d_ff=32,
           max_context=CTX)
# the bank's stats both packages report
BANK_KEYS = ("resident", "cold", "detached", "in_use", "pages_total",
             "pages_used", "pages_free", "publishes", "acquires",
             "evictions", "max_adapters", "page_rank",
             "max_pages_per_adapter")


def _factors(seed, rank, scale=0.05):
    rng = np.random.RandomState(seed)
    a = (rng.randn(L, 4, D, rank) * scale).astype(np.float32)
    b = (rng.randn(L, 4, rank, D) * scale).astype(np.float32)
    return a, b


def _publish(banks, name, seed, rank, alpha=None):
    a, b = _factors(seed, rank)
    versions = {bk.publish(name, a, b, alpha=alpha) for bk in banks}
    assert len(versions) == 1
    return versions.pop()


@pytest.fixture(scope="module")
def world():
    """(JAX model, port model, numpy params, JAX bank, port bank, JAX
    engine, port engine, port stats): 'ada' (rank 4, one page) and 'bob'
    (rank 8, two pages, alpha 4) published into both banks, both engines
    warmed."""
    jm = jllm.TinyDecoder(jllm.DecoderConfig(**CFG))
    tm = tllm.TinyDecoder(tllm.DecoderConfig(**CFG), device="cpu")
    npp = jm.init_params(seed=0)
    jb = JBank(L, D, max_adapters=4, page_rank=4)
    tb = AdapterBank(L, D, max_adapters=4, page_rank=4, device="cpu")
    _publish((jb, tb), "ada", 1, 4)
    _publish((jb, tb), "bob", 2, 8, alpha=4.0)
    je = jllm.LLMEngine(jm, npp, max_seqs=4, block_size=BS,
                        max_context=CTX, prefix_cache=True,
                        adapter_bank=jb)
    stats = LLMStats()
    te = tllm.LLMEngine(tm, npp, max_seqs=4, block_size=BS,
                        max_context=CTX, prefix_cache=True,
                        adapter_bank=tb, stats=stats, device="cpu")
    je.warmup()
    assert "adapter_install" in te.warmup()
    return jm, tm, npp, jb, tb, je, te, stats


def _oracle(world, prompt, n, adapter):
    jm, _, npp, jb, _, _, _, _ = world
    lora = None if adapter is None else jb.adapter_arrays(adapter)
    return list(jllm.greedy_decode_reference(jm, npp, prompt, n, lora=lora))


def _lockstep(je, te, cases, stagger_from=None, check=None):
    """Drive both engines with the same traffic (the tail injected one
    sequence every other step from ``stagger_from``), comparing host
    state after every step. Returns the port's sequences."""
    jseqs = [jllm.Sequence(p, n, adapter=a) for p, n, a in cases]
    tseqs = [tllm.Sequence(p, n, adapter=a) for p, n, a in cases]
    cut = len(cases) if stagger_from is None else stagger_from
    for a, b in zip(jseqs[:cut], tseqs[:cut]):
        je.add(a)
        te.add(b)
    injected, steps = cut, 0
    while je.has_work() or te.has_work() or injected < len(cases):
        if injected < len(cases) and (steps % 2 == 0
                                      or not te.has_work()):
            je.add(jseqs[injected])
            te.add(tseqs[injected])
            injected += 1
        ev_j, ev_t = je.step(), te.step()
        steps += 1
        assert steps < 2000
        assert [k for k, _ in ev_j] == [k for k, _ in ev_t], steps
        for a, b in zip(jseqs, tseqs):
            assert (a.generated, a.seq_len, a.block_ids, a.state) == \
                (b.generated, b.seq_len, b.block_ids, b.state), steps
            assert a.prefix_hashes == b.prefix_hashes, steps
            ha, hb = a.adapter_handle, b.adapter_handle
            assert (ha is None) == (hb is None)
            if ha is not None:
                assert (ha.name, ha.version, ha.scale,
                        tuple(ha.pages_padded)) == \
                    (hb.name, hb.version, hb.scale, tuple(hb.pages_padded))
        ja, ta = je.cache.allocator, te.cache.allocator
        assert ja.num_free == ta.num_free and ja._ref == ta._ref, steps
        if check is not None:
            check()
    je.pop_finished()
    te.pop_finished()
    return tseqs


def _banks_agree(jb, tb):
    sj, st = jb.stats(), tb.stats()
    assert {k: sj[k] for k in BANK_KEYS} == {k: st[k] for k in BANK_KEYS}
    assert jb._alloc._ref == tb._alloc._ref
    assert {n: r.pages for n, r in jb._resident.items()} == \
        {n: r.pages for n, r in tb._resident.items()}


# --------------------------------------- mixed-adapter lockstep ----------
def test_mixed_adapter_batch_lockstep_with_the_jax_engine(world):
    """8 sequences under 'ada', 'bob' and the base model, ragged prompts
    at and around the block boundary, staggered admission: identical
    host state with the JAX engine after every step, the banks' stats
    and page ids identical throughout, every stream the per-adapter
    oracle's, and the bank drained to zero users."""
    _, _, _, jb, tb, je, te, stats = world
    before = tb.stats()
    rng = np.random.RandomState(11)
    adapters = [None, "ada", "bob", None, "ada", "bob", "ada", None]
    cases = []
    for i, ad in enumerate(adapters):
        plen = (BS - 1, BS, BS + 1)[i] if i < 3 else int(rng.randint(1, 21))
        prompt = rng.randint(0, VOCAB, size=plen).tolist()
        cases.append((prompt, int(rng.randint(2, 9)), ad))
    seqs = _lockstep(je, te, cases, stagger_from=4,
                     check=lambda: _banks_agree(jb, tb))
    for (prompt, n, ad), s in zip(cases, seqs):
        assert s.state == "finished"
        assert s.output_tokens() == _oracle(world, prompt, n, ad), ad
    after = tb.stats()
    assert after["in_use"] == 0
    assert after["acquires"] - before["acquires"] == 5
    assert tb.check() and jb.check()
    assert te.cache.allocator.num_used == 0
    snap = stats.snapshot()
    assert snap["adapter_requests"]["ada"] >= 3
    assert snap["adapter_requests"]["bob"] >= 2
    assert snap["adapters_resident"] == len(tb.names())


# ------------------------------------ adapter-namespaced prefix cache --
def test_prefix_cache_is_adapter_namespaced(world):
    """Same prompt, three namespaces: a repeat under the same adapter
    hits (bit-exact), under another adapter or the base model never
    cross-hits; the port's hits and hashes equal the JAX engine's."""
    _, _, _, jb, tb, je, te, _ = world
    rng = np.random.RandomState(23)
    prompt = rng.randint(0, VOCAB, size=2 * BS + 1).tolist()
    lk0, h0 = te.prefix_lookups, te.prefix_hits
    w1 = _lockstep(je, te, [(prompt, 5, "ada"), (prompt, 5, None)])
    assert te.prefix_lookups == lk0 + 2 and te.prefix_hits == h0
    w2 = _lockstep(je, te, [(prompt, 5, "ada"), (prompt, 5, "bob"),
                            (prompt, 5, None)])
    assert te.prefix_lookups == lk0 + 5
    assert te.prefix_hits == h0 + 2
    assert (te.prefix_lookups, te.prefix_hits) == \
        (je.prefix_lookups, je.prefix_hits)
    assert [s.cache_hit_tokens for s in w2] == [2 * BS, 0, 2 * BS]
    assert w1[0].prefix_hashes != w1[1].prefix_hashes
    for s, ad in zip(w1 + w2, ["ada", None, "ada", "bob", None]):
        assert s.output_tokens() == _oracle(world, prompt, 5, ad), ad
    assert tb.stats()["in_use"] == 0 and tb.check()


# ----------------------------------------- churn builds nothing ------
def test_adapter_churn_builds_and_captures_nothing(world):
    """Publish a new adapter (rank 2: a zero-padded tail page), serve it,
    evict it cold, publish it again, republish a live name while a
    sequence holds the old version: nothing built, captured or added to
    the engine's programs, every stream the oracle's with the factors
    it pinned, the JAX bank in step."""
    _, _, _, jb, tb, je, te, _ = world
    rng = np.random.RandomState(31)
    prompt = rng.randint(0, VOCAB, size=9).tolist()
    compiles, progs = compile_count(), te.programs()
    _publish((jb, tb), "cal", 3, 2)
    s = _lockstep(je, te, [(prompt, 4, "cal")])[0]
    assert s.output_tokens() == _oracle(world, prompt, 4, "cal")
    for bk in (jb, tb):
        bk.evict("cal")
    assert "cal" not in tb.names()
    _publish((jb, tb), "cal", 4, 3)
    s = _lockstep(je, te, [(prompt, 4, "cal")])[0]
    assert s.output_tokens() == _oracle(world, prompt, 4, "cal")
    # a live republish: the running sequence keeps the old version
    want_old = _oracle(world, prompt, 6, "ada")
    jold = jllm.Sequence(prompt, 6, adapter="ada")
    told = tllm.Sequence(prompt, 6, adapter="ada")
    je.add(jold)
    te.add(told)
    je.step()
    te.step()
    assert told.adapter_handle is not None
    v1 = told.adapter_handle.version
    v2 = _publish((jb, tb), "ada", 41, 4)
    assert v2 == v1 + 1 and tb.stats()["detached"] == 1
    while je.has_work() or te.has_work():
        je.step()
        te.step()
    assert told.output_tokens() == jold.output_tokens() == want_old
    assert tb.stats()["detached"] == 0
    s = _lockstep(je, te, [(prompt, 4, "ada")])[0]
    assert s.adapter_handle is None
    assert s.output_tokens() == _oracle(world, prompt, 4, "ada")
    assert compile_count() == compiles
    after = te.programs()
    assert (after["step_variants"], after["graphs"]) == \
        (progs["step_variants"], progs["graphs"])
    assert tb.check()
    _banks_agree(jb, tb)


# ------------------------------------------- poison and submit ------
def test_unknown_adapter_poisons_without_leaking(world):
    _, _, _, _, tb, _, te, _ = world
    st0 = tb.stats()
    s = tllm.Sequence([1, 2, 3], 4, adapter="ghost")
    te.add(s)
    steps = 0
    while te.has_work():
        te.step()
        steps += 1
        assert steps < 50
    assert s.state == "evicted" and s.finish_reason == "poison"
    seq, exc = te.pop_poison()[-1]
    assert seq is s and isinstance(exc, UnknownAdapterError)
    st1 = tb.stats()
    assert st1["in_use"] == 0 and st1["pages_used"] == st0["pages_used"]
    assert te.cache.allocator.num_used == 0


def test_submit_adapter_needs_a_bank_and_a_known_name(world):
    """``submit(adapter=)`` on a bank-less server raises ``ValueError``
    on the caller's thread; with a bank an unknown name raises
    ``UnknownAdapterError`` and a known one serves the oracle's stream;
    ``stats()["adapters"]`` is the bank's."""
    _, tm, npp, _, tb, _, _, _ = world
    srv = tllm.LLMServer(tm, npp, name="adapters_nobank", max_seqs=4,
                         block_size=BS, max_context=CTX, device="cpu")
    srv.start()
    try:
        with pytest.raises(ValueError, match="no AdapterBank"):
            srv.submit([1, 2], 2, adapter="ada")
        assert "adapters" not in srv.stats()
    finally:
        srv.shutdown(drain=False)
    # a bank of its own: a bank reports to the first stats it meets
    tb = AdapterBank(L, D, max_adapters=4, page_rank=4, device="cpu")
    _publish((tb,), "ada", 1, 4)
    _publish((tb,), "bob", 2, 8, alpha=4.0)
    srv = tllm.LLMServer(tm, npp, name="adapters_bank", max_seqs=4,
                         block_size=BS, max_context=CTX, adapter_bank=tb,
                         device="cpu")
    srv.warmup()
    srv.start()
    try:
        with pytest.raises(UnknownAdapterError):
            srv.submit([1, 2], 2, adapter="ghost")
        out = srv.generate([3, 1, 4, 1, 5], 6, adapter="bob", timeout=60,
                           tenant="acme")
        assert out.tokens == _oracle(world, [3, 1, 4, 1, 5], 6, "bob")
        st = srv.stats()
    finally:
        srv.shutdown()
    assert st["adapters"] == tb.stats()
    assert st["adapter_requests"] == {"bob": 1}
    assert st["tenant_adapter_requests"] == {"acme/bob": 1}
    assert st["adapters_resident"] == 2
    assert tb.stats()["in_use"] == 0 and tb.check()


def test_bank_and_engine_refuse_what_they_do_not_take(world, tmp_path):
    _, tm, npp, _, _, _, _, _ = world
    # a registry is taken (tests/test_torch_registry.py); a name it does
    # not hold stays unknown
    reg_bank = AdapterBank(L, D, registry=AdapterRegistry(str(tmp_path)),
                           device="cpu")
    assert not reg_bank.known("ghost")
    with pytest.raises(UnknownAdapterError):
        reg_bank.acquire("ghost")
    bad = AdapterBank(L + 1, D, max_adapters=1, device="cpu")
    with pytest.raises(ValueError, match="layers"):
        tllm.LLMEngine(tm, npp, max_seqs=2, block_size=BS,
                       max_context=CTX, adapter_bank=bad, device="cpu")
    bk = AdapterBank(L, D, max_adapters=1, page_rank=2,
                     max_pages_per_adapter=1, device="cpu")
    with pytest.raises(Exception, match="caps at 1 pages"):
        bk.publish("big", *_factors(1, 4))
    with pytest.raises(Exception, match="A factors"):
        bk.publish("bad", np.zeros((L, 4, D + 1, 2), np.float32),
                   np.zeros((L, 4, 2, D), np.float32))


# --------------------------------------------- bank fuzzing -----------
class _ShadowFull(Exception):
    pass


class _ShadowBank:
    """Host-side replica of the bank's accounting (the reference test's
    ``_ShadowBank``): refcounts, page ownership and the cold-LRU order."""

    def __init__(self, pages_total):
        import collections
        self.pages_total = pages_total
        self.resident = {}
        self.users = {}
        self.npages = {}
        self.cold = collections.OrderedDict()

    def free_pages(self):
        return self.pages_total - sum(self.npages.values())

    def retire(self, name):
        v = self.resident.pop(name)
        self.cold.pop(name, None)
        if self.users.get((name, v), 0) == 0:
            self.users.pop((name, v), None)
            self.npages.pop((name, v), None)

    def publish(self, name, need, version):
        old = self.resident.get(name)
        if old is not None and self.users.get((name, old), 0) == 0:
            self.retire(name)
            old = None
        while self.free_pages() < need:
            victim = next(iter(self.cold), None)
            if victim is None:
                raise _ShadowFull
            self.retire(victim)
        if old is not None:
            self.retire(name)
        self.resident[name] = version
        self.npages[(name, version)] = need
        self.users.setdefault((name, version), 0)
        self.cold[name] = None

    def acquire(self, name):
        v = self.resident[name]
        self.users[(name, v)] += 1
        self.cold.pop(name, None)
        return v

    def release(self, name, v):
        self.users[(name, v)] -= 1
        if self.users[(name, v)] == 0:
            if self.resident.get(name) == v:
                self.cold[name] = None
            else:
                self.users.pop((name, v))
                self.npages.pop((name, v))


def test_adapter_bank_fuzz_shadow_refcounts():
    """600 randomized publish / acquire / release / evict steps on a
    tiny pool (3 adapters x 2 pages of rank 2) against the shadow model:
    every typed error fires exactly when the shadow says, capacity
    evictions hit the adapters the shadow's LRU predicts, ``check()``
    holds, and the final drain returns every page."""
    rng = np.random.RandomState(7)
    dL, dD = 2, 8
    bk = AdapterBank(dL, dD, max_adapters=3, page_rank=2,
                     max_pages_per_adapter=2, device="cpu")
    sh = _ShadowBank(bk.stats()["pages_total"])
    names = [f"f{i}" for i in range(6)]
    live, released = [], []
    for step in range(600):
        op = int(rng.randint(4))
        if op == 0:
            name = names[int(rng.randint(len(names)))]
            rank = int(rng.randint(1, 5))
            a = (rng.randn(dL, 4, dD, rank) * 0.01).astype(np.float32)
            b = (rng.randn(dL, 4, rank, dD) * 0.01).astype(np.float32)
            try:
                v = bk.publish(name, a, b, persist=False)
            except NoFreeAdapterPagesError:
                v = None
            try:
                sh.publish(name, -(-rank // 2), v)
                assert v is not None, step
            except _ShadowFull:
                assert v is None, step
        elif op == 1:
            res = bk.names()
            if res:
                name = res[int(rng.randint(len(res)))]
                h = bk.acquire(name)
                assert h.version == sh.acquire(name)
                live.append((name, h.version, h))
            elif step % 7 == 0:
                with pytest.raises(UnknownAdapterError):
                    bk.acquire("nope")
        elif op == 2:
            if live:
                name, v, h = live.pop(int(rng.randint(len(live))))
                bk.release(h)
                sh.release(name, v)
                released.append(h)
        else:
            res = bk.names()
            if res:
                name = res[int(rng.randint(len(res)))]
                v = sh.resident[name]
                if sh.users.get((name, v), 0) > 0:
                    with pytest.raises(AdapterAccountingError):
                        bk.evict(name)
                else:
                    bk.evict(name)
                    sh.retire(name)
            else:
                with pytest.raises(UnknownAdapterError):
                    bk.evict("f0")
        assert sorted(sh.resident) == bk.names(), step
        if step % 50 == 0:
            assert bk.check()
            st = bk.stats()
            assert st["resident"] == len(sh.resident)
            assert st["cold"] == len(sh.cold)
            assert st["pages_used"] == sum(sh.npages.values())
    for name, v, h in live:
        bk.release(h)
        sh.release(name, v)
    for name in bk.names():
        bk.evict(name)
    st = bk.stats()
    assert st["pages_used"] == 0 and st["resident"] == 0 \
        and st["detached"] == 0
    assert bk.check()
    with pytest.raises(AdapterAccountingError, match="double release"):
        bk.release(released[-1])


# ------------------------------------- speculative decoding ----------
def test_spec_decode_under_mixed_adapters(world):
    """A one-layer base draft proposes, the adapter-bearing target
    verifies: greedy streams stay the per-adapter oracle's, proposals
    are made, the bank drains."""
    _, tm, npp, _, tb, _, _, _ = world
    draft = tllm.TinyDecoder(tllm.DecoderConfig(**dict(CFG, num_layers=1)),
                             device="cpu")
    dparams = dict(npp, layers=list(npp["layers"][:1]))
    stats = LLMStats()
    eng = tllm.LLMEngine(tm, npp, max_seqs=4, block_size=BS,
                         max_context=CTX, prefix_cache=True,
                         adapter_bank=tb, draft_model=draft,
                         draft_params=dparams, spec_k=2, stats=stats,
                         device="cpu")
    eng.warmup()
    rng = np.random.RandomState(47)
    cases = []
    for ad in ["ada", "bob", None, "ada"]:
        prompt = rng.randint(0, VOCAB, size=int(rng.randint(3, 20))).tolist()
        cases.append((prompt, int(rng.randint(3, 9)), ad))
    seqs = [tllm.Sequence(p, n, adapter=a) for p, n, a in cases]
    for s in seqs[:2]:
        eng.add(s)
    steps = 0
    while eng.has_work() or steps < 2:
        if steps == 1:
            for s in seqs[2:]:
                eng.add(s)
        eng.step()
        steps += 1
        assert steps < 500
    for (prompt, n, ad), s in zip(cases, seqs):
        assert s.state == "finished"
        assert s.output_tokens() == _oracle(world, prompt, n, ad), ad
    assert stats.snapshot()["spec_proposed"] > 0
    assert tb.stats()["in_use"] == 0 and tb.check()
    assert eng.cache.allocator.num_used == 0


def test_a_huge_cold_adapter_reaches_no_other_row(world):
    """A resident, cold adapter with finite factors of +-3e38 (its
    ``x @ A`` overflows) published into both banks: base rows and the
    other adapters' rows keep in lockstep with the JAX engine, which
    gathers only a row's own pages, and every stream is the oracle's."""
    _, _, _, jb, tb, je, te, _ = world
    a, b = _factors(5, 8)
    a = np.sign(a) * np.float32(3e38)
    assert len({bk.publish("big", a, b) for bk in (jb, tb)}) == 1
    try:
        rng = np.random.RandomState(29)
        cases = [(rng.randint(0, VOCAB, size=n).tolist(), 6, ad)
                 for n, ad in ((5, None), (9, "ada"), (12, "bob"),
                               (3, None))]
        seqs = _lockstep(je, te, cases)
        assert {n: r.pages for n, r in jb._resident.items()} == \
            {n: r.pages for n, r in tb._resident.items()}
        for (prompt, n, ad), s in zip(cases, seqs):
            assert s.state == "finished"
            assert s.output_tokens() == _oracle(world, prompt, n, ad), ad
    finally:
        for bk in (jb, tb):
            bk.evict("big")
    assert tb.check() and jb.check()

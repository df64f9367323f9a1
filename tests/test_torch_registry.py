"""PyTorch port, the adapter registry (``mxnet_tpu_torch/serving/adapters/
registry.py``) and the bank's fault-in (``AdapterBank(registry=)``)
against the JAX package's, on the CPU.

- registry directories written by either package are read by the other
  (v1 and sharded v2 checkpoints, versions, alpha, ``has``/``names``,
  the name rule);
- a randomized publish / acquire / release / evict storm on a JAX bank
  and a port bank, each over its own registry: every acquire of a
  registered, non-resident name faults it in, and after every operation
  both banks hold the same residents, pages, refcounts,
  ``registry_loads`` and evictions (the shadow-refcount fuzz of
  ``tests/test_adapters.py`` with a registry);
- the reference's fixture (vocab 17, block 8, context 32, 2 layers,
  d_model 16; a bank of 4 adapters of page rank 4 over a 2-shard
  registry): publish, serve, evict cold, fault back in, republish a live
  name, in lockstep with the JAX engine (the counterpart of
  ``tests/test_adapters.py::test_adapter_churn_never_recompiles``): the
  same streams and ``registry_loads``, nothing built or captured;
- ``LLMServer.submit(adapter=)`` of a name only the registry holds
  (written by the JAX package) serves the JAX oracle's stream and drops
  an ``adapter.fault_in`` flight event; a registry holding non-finite
  factors is refused.
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
from mxnet_tpu.serving.adapters import (  # noqa: E402
    AdapterRegistry as JRegistry)
from mxnet_tpu.serving.adapters import bank as jbank_mod  # noqa: E402
from mxnet_tpu_torch.observability import get_flightrecorder  # noqa: E402
from mxnet_tpu_torch.serving import llm as tllm  # noqa: E402
from mxnet_tpu_torch.serving.adapters import (  # noqa: E402
    AdapterBank, AdapterError, AdapterRegistry, NoFreeAdapterPagesError,
    UnknownAdapterError)
from mxnet_tpu_torch.serving.telemetry import compile_count  # noqa: E402

torch.set_num_threads(2)

VOCAB, BS, CTX, L, D = 17, 8, 32, 2, 16
CFG = dict(vocab_size=VOCAB, d_model=D, num_layers=L, num_heads=2, d_ff=32,
           max_context=CTX)
BANK_KEYS = ("resident", "cold", "detached", "in_use", "pages_total",
             "pages_used", "pages_free", "publishes", "acquires",
             "acquire_hits", "registry_loads", "evictions")


def _factors(seed, rank, layers=L, d_model=D, scale=0.05):
    rng = np.random.RandomState(seed)
    a = (rng.randn(layers, 4, d_model, rank) * scale).astype(np.float32)
    b = (rng.randn(layers, 4, rank, d_model) * scale).astype(np.float32)
    return a, b


def _banks_agree(jb, tb):
    sj, st = jb.stats(), tb.stats()
    assert {k: sj[k] for k in BANK_KEYS} == {k: st[k] for k in BANK_KEYS}
    assert jb._alloc._ref == tb._alloc._ref
    assert {n: (r.version, r.pages, r.users)
            for n, r in jb._resident.items()} == \
        {n: (r.version, r.pages, r.users) for n, r in tb._resident.items()}
    assert list(jb._cold) == list(tb._cold)


# --------------------------------------------------- registry on disk ----
@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("num_shards", [None, 2])
def test_registry_dirs_cross_read(tmp_path, writer, num_shards):
    """Versions saved by one package load in the other with the same
    factor bits, alpha and version; ``keep`` prunes the same way."""
    root = str(tmp_path / "reg")
    cls, other = ((JRegistry, AdapterRegistry) if writer == "jax"
                  else (AdapterRegistry, JRegistry))
    w = cls(root, num_shards=num_shards, keep=2)
    for v in (1, 2, 3):
        w.save("ada", *_factors(v, 4), alpha=2.0 * v, version=v)
    w.save("bob.v2", *_factors(9, 8), version=1)
    r = other(root, num_shards=num_shards, keep=2)
    assert r.names() == ["ada", "bob.v2"] and r.has("ada")
    a, b, alpha, version = r.load("ada")
    want_a, want_b = _factors(3, 4)
    assert (alpha, version) == (6.0, 3)
    assert a.dtype == np.float32 and np.array_equal(a, want_a)
    assert np.array_equal(b, want_b)
    a, b, alpha, version = r.load("bob.v2")
    assert (alpha, version) == (None, 1)
    assert np.array_equal(b, _factors(9, 8)[1])
    assert sorted(os.listdir(os.path.join(root, "ada"))) == \
        ["LATEST", "ckpt-0000000002", "ckpt-0000000003"]
    with pytest.raises(KeyError):
        r.load("cal")


def test_registry_name_rule_is_the_reference_rule(tmp_path):
    t, j = AdapterRegistry(str(tmp_path / "t")), JRegistry(
        str(tmp_path / "j"))
    for name in ("", ".hidden", "-x", "a/b", "a b", "../up"):
        for reg in (t, j):
            with pytest.raises(ValueError):
                reg.save(name, *_factors(1, 2))
            assert not reg.has(name)
    for name in ("a", "A.b-c_d", "0x"):
        t.save(name, *_factors(1, 2))
        assert t.has(name)
    assert t.names() == ["0x", "A.b-c_d", "a"]


# ------------------------------------------------------ the bank fuzz ----
def test_registry_bank_fuzz_matches_the_jax_bank(tmp_path):
    """300 random publish / acquire / release / evict operations on a
    tiny pool (3 adapters x 2 pages of rank 2), the same on a JAX bank
    and a port bank over registries of their own: acquires of
    registered names fault them in, evicting cold residents; the same
    outcome and typed error every operation, and the same residents,
    pages, refcounts, cold order, ``registry_loads`` and evictions."""
    rng = np.random.RandomState(7)
    dL, dD = 2, 8
    geo = dict(max_adapters=3, page_rank=2, max_pages_per_adapter=2)
    jb = JBank(dL, dD, registry=JRegistry(str(tmp_path / "j"), keep=2),
               **geo)
    tb = AdapterBank(dL, dD, registry=AdapterRegistry(
        str(tmp_path / "t"), keep=2), device="cpu", **geo)
    names = [f"f{i}" for i in range(6)]
    live = []
    for step in range(300):
        op = int(rng.randint(4))
        if op == 0:
            name = names[int(rng.randint(len(names)))]
            rank = int(rng.randint(1, 5))
            a = (rng.randn(dL, 4, dD, rank) * 0.01).astype(np.float32)
            b = (rng.randn(dL, 4, rank, dD) * 0.01).astype(np.float32)
            outs = []
            for bk in (jb, tb):
                try:
                    outs.append(bk.publish(name, a, b))
                except (jbank_mod.NoFreeAdapterPagesError,
                        NoFreeAdapterPagesError) as e:
                    outs.append(type(e).__name__)
            assert outs[0] == outs[1], step
        elif op == 1:
            name = names[int(rng.randint(len(names)))]
            outs = []
            for bk in (jb, tb):
                try:
                    outs.append(bk.acquire(name))
                except (jbank_mod.AdapterError, AdapterError) as e:
                    outs.append(type(e).__name__)
            if isinstance(outs[0], str):
                assert outs[0] == outs[1], step
            else:
                assert (outs[0].version, tuple(outs[0].pages_padded)) == \
                    (outs[1].version, tuple(outs[1].pages_padded)), step
                live.append(outs)
        elif op == 2:
            if live:
                hj, ht = live.pop(int(rng.randint(len(live))))
                jb.release(hj)
                tb.release(ht)
        else:
            res = tb.names()
            assert res == jb.names()
            if res:
                name = res[int(rng.randint(len(res)))]
                outs = []
                for bk in (jb, tb):
                    try:
                        bk.evict(name)
                        outs.append("ok")
                    except (jbank_mod.AdapterError, AdapterError) as e:
                        outs.append(type(e).__name__)
                assert outs[0] == outs[1], step
        assert tb.known(names[step % 6]) == jb.known(names[step % 6])
        _banks_agree(jb, tb)
        if step % 25 == 0:
            assert tb.check() and jb.check()
    assert tb.stats()["registry_loads"] > 10
    assert tb.stats()["evictions"]["capacity"] > 10
    for hj, ht in live:
        jb.release(hj)
        tb.release(ht)
    _banks_agree(jb, tb)
    assert tb.check() and tb.stats()["in_use"] == 0


def test_fault_in_refuses_non_finite_registry_factors(tmp_path):
    reg = AdapterRegistry(str(tmp_path / "reg"))
    a, b = _factors(1, 4)
    a[0, 0, 0, 0] = np.nan
    reg.save("bad", a, b)
    reg.save("good", *_factors(2, 4))
    bk = AdapterBank(L, D, max_adapters=2, page_rank=4, registry=reg,
                     device="cpu")
    assert bk.known("bad") and not bk.known("ghost")
    with pytest.raises(AdapterError, match="not finite"):
        bk.acquire("bad")
    with pytest.raises(UnknownAdapterError):
        bk.acquire("ghost")
    h = bk.acquire("good")
    assert bk.stats()["registry_loads"] == 1 and bk.names() == ["good"]
    bk.release(h)
    assert bk.check()


# ------------------------------------------- serving with fault-in -------
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX model, port model, numpy params, JAX bank, port bank, JAX
    engine, port engine): the reference's fixture, each bank over its
    own 2-shard registry with 'ada' (rank 4) and 'bob' (rank 8, alpha
    4) published, both engines warmed."""
    jm = jllm.TinyDecoder(jllm.DecoderConfig(**CFG))
    tm = tllm.TinyDecoder(tllm.DecoderConfig(**CFG), device="cpu")
    npp = jm.init_params(seed=0)
    jb = JBank(L, D, max_adapters=4, page_rank=4, registry=JRegistry(
        tmp_path_factory.mktemp("jreg"), num_shards=2))
    tb = AdapterBank(L, D, max_adapters=4, page_rank=4,
                     registry=AdapterRegistry(
                         tmp_path_factory.mktemp("treg"), num_shards=2),
                     device="cpu")
    for bk in (jb, tb):
        bk.publish("ada", *_factors(1, 4))
        bk.publish("bob", *_factors(2, 8), alpha=4.0)
    je = jllm.LLMEngine(jm, npp, max_seqs=4, block_size=BS,
                        max_context=CTX, prefix_cache=True,
                        adapter_bank=jb)
    te = tllm.LLMEngine(tm, npp, max_seqs=4, block_size=BS,
                        max_context=CTX, prefix_cache=True,
                        adapter_bank=tb, device="cpu")
    je.warmup()
    te.warmup()
    return jm, tm, npp, jb, tb, je, te


def _serve_both(je, te, prompt, n, adapter):
    """One sequence through each engine to the end; the port's."""
    js = jllm.Sequence(prompt, n, adapter=adapter)
    ts = tllm.Sequence(prompt, n, adapter=adapter)
    je.add(js)
    te.add(ts)
    steps = 0
    while je.has_work() or te.has_work():
        je.step()
        te.step()
        steps += 1
        assert steps < 200
    je.pop_finished()
    te.pop_finished()
    assert ts.output_tokens() == js.output_tokens()
    return ts


def _oracle(world, prompt, n, adapter):
    jm, _, npp, jb, _, _, _ = world
    return list(jllm.greedy_decode_reference(
        jm, npp, prompt, n, lora=jb.adapter_arrays(adapter)))


def test_churn_with_registry_fault_in_matches_the_jax_engine(world):
    """Publish a new adapter, serve it, evict it cold, fault it back in
    from the registry, republish a live name: the same streams as the
    JAX engine (the per-adapter oracle's), the same ``registry_loads``,
    nothing built or captured."""
    _, _, _, jb, tb, je, te = world
    rng = np.random.RandomState(31)
    prompt = rng.randint(0, VOCAB, size=9).tolist()
    compiles = compile_count()
    for bk in (jb, tb):
        bk.publish("cal", *_factors(3, 2))            # rank 2: tail pad
    s = _serve_both(je, te, prompt, 4, "cal")
    assert s.output_tokens() == _oracle(world, prompt, 4, "cal")
    for bk in (jb, tb):
        bk.evict("cal")
    assert "cal" not in tb.names() and tb.known("cal")
    loads0 = tb.stats()["registry_loads"]
    s2 = _serve_both(je, te, prompt, 4, "cal")        # the fault-in
    assert tb.stats()["registry_loads"] == loads0 + 1 == \
        jb.stats()["registry_loads"]
    assert s2.output_tokens() == s.output_tokens()
    assert s2.adapter_handle is None
    v2 = {bk.publish("ada", *_factors(41, 4)) for bk in (jb, tb)}
    assert len(v2) == 1 and tb.resident_version("ada") == v2.pop()
    s3 = _serve_both(je, te, prompt, 4, "ada")
    assert s3.output_tokens() == _oracle(world, prompt, 4, "ada")
    assert compile_count() == compiles
    _banks_agree(jb, tb)
    assert tb.check()


def test_capacity_eviction_and_fault_back_in_across_waves(world):
    """Three new adapters of rank 8 outgrow the pool: cold residents are
    evicted for capacity; a wave under the evicted names faults them
    back in, the same on both engines."""
    _, _, _, jb, tb, je, te = world
    rng = np.random.RandomState(37)
    prompts = [rng.randint(0, VOCAB, size=n).tolist() for n in (5, 11)]
    for bk in (jb, tb):
        bk.publish("dan", *_factors(5, 8))
        bk.publish("eve", *_factors(6, 8))
        bk.publish("fay", *_factors(7, 8))
    _banks_agree(jb, tb)
    ev0 = tb.stats()["evictions"]["capacity"]
    gone = [n for n in ("ada", "bob", "cal") if n not in tb.names()]
    assert gone and ev0 > 0
    for p, ad in zip(prompts, gone + gone):
        s = _serve_both(je, te, p, 5, ad)
        assert s.output_tokens() == _oracle(world, p, 5, ad)
    _banks_agree(jb, tb)
    assert tb.stats()["evictions"]["capacity"] > ev0
    assert tb.check() and tb.stats()["in_use"] == 0


def test_server_faults_in_a_name_only_the_registry_holds(world, tmp_path):
    """``submit(adapter=)`` of a name the JAX package wrote into the
    registry and no bank ever published: accepted (``known`` asks the
    registry), served as the JAX oracle serves its factors, one
    ``registry_loads``, an ``adapter.fault_in`` flight event."""
    jm, tm, npp, _, _, _, _ = world
    root = str(tmp_path / "reg")
    a, b = _factors(77, 8)
    JRegistry(root, num_shards=2).save("zed", a, b, alpha=2.0, version=5)
    bank = AdapterBank(L, D, max_adapters=2, page_rank=4,
                       registry=AdapterRegistry(root, num_shards=2),
                       device="cpu")
    jbank = JBank(L, D, max_adapters=2, page_rank=4)
    jbank.publish("zed", a, b, alpha=2.0)
    fr = get_flightrecorder()
    was = fr.enabled
    fr.enable()
    srv = tllm.LLMServer(tm, npp, name="registry_srv", max_seqs=2,
                         block_size=BS, max_context=CTX, adapter_bank=bank,
                         device="cpu")
    srv.warmup()
    srv.start()
    try:
        with pytest.raises(UnknownAdapterError):
            srv.submit([1, 2], 2, adapter="ghost")
        out = srv.generate([3, 1, 4, 1, 5], 6, adapter="zed", timeout=60)
        st = srv.stats()
        events = [e for e in fr.snapshot()
                  if e.get("kind") == "adapter.fault_in"]
    finally:
        srv.shutdown()
        if not was:
            fr.disable()
    assert out.tokens == list(jllm.greedy_decode_reference(
        jm, npp, [3, 1, 4, 1, 5], 6, lora=jbank.adapter_arrays("zed")))
    assert st["adapters"]["registry_loads"] == 1
    assert st["adapters"]["acquire_hits"] == 0
    assert bank.resident_version("zed") == 5
    assert events and events[-1]["attrs"] == {
        "adapter": "zed", "version": 5, "rank": 8, "pages": 2}
    assert bank.check() and bank.stats()["in_use"] == 0

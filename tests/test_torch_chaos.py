"""PyTorch port, the serving chaos matrix: the LLM half of
``tests/test_serving_chaos.py`` (``:344-900``) run against
``mxnet_tpu_torch``'s ``LLMServer`` on the CPU, armed through the port's
own switchboard (``mxnet_tpu_torch.resilience.faults``: the engine's
``llm.prefill`` / ``llm.draft`` / ``llm.decode`` sites and the server
loop's ``llm.worker``), at that file's tiny model (vocab 17, d_model 16,
1 layer, 2 heads, ``max_seqs=2``, blocks of 8, context 32).

The invariant under every fault: every Future resolves, with a result or
a typed error; survivors' greedy streams equal the JAX package's
``greedy_decode_reference`` (computed once per prompt for the module);
the pool ends with no block in use and ``cache.check`` clean; nothing is
built or captured after ``warmup()`` (``CompileCounter``).

Also here, against the port:

- the request timeline, TTFT exemplar and statusz of
  ``tests/test_flightrecorder.py:350`` (the flight bundle read by
  ``tools/flight_inspect.py``);
- ``debug_status()``'s keys against the JAX server's, for the same
  configuration;
- the same sequential traffic through a JAX and a port server: the same
  ``mxtpu_llm_*`` / ``mxtpu_serving_*`` series, equal counter values and
  histogram counts (time-valued sums and gauges left out);
- worker death with live adapters settles the bank's refcounts (the
  counterpart of ``tests/test_adapters.py:415``).

The reference marks three of its cases ``slow`` (prefill poison and the
two mid-verify ones, 13-30 s each on its compiled engine); the port's
eager CPU engine runs them in about a second, so none is marked here.
"""
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch  # noqa: E402

from mxnet_tpu.serving import llm as jllm  # noqa: E402
from mxnet_tpu_torch import serving  # noqa: E402
from mxnet_tpu_torch.observability import (  # noqa: E402
    get_flightrecorder, get_registry, get_tracer, validate_chrome_trace)
from mxnet_tpu_torch.observability.exemplars import collect  # noqa: E402
from mxnet_tpu_torch.observability.flightrecorder import (  # noqa: E402
    flight_ring_capacity)
from mxnet_tpu_torch.resilience import PreemptionGuard, faults  # noqa: E402
from mxnet_tpu_torch.serving import (  # noqa: E402
    CircuitOpenError, DeadlineExceededError, Overloaded,
    SequenceEvictedError, ServerClosed, ServingError)
from mxnet_tpu_torch.serving import llm as tllm  # noqa: E402
from mxnet_tpu_torch.serving.adapters import AdapterBank  # noqa: E402

torch.set_num_threads(2)

VOCAB, BS, CTX = 17, 8, 32
CFG = dict(vocab_size=VOCAB, d_model=16, num_layers=1, num_heads=2,
           d_ff=32, max_context=CTX)
DRAFT_CFG = dict(vocab_size=VOCAB, d_model=8, num_layers=1, num_heads=1,
                 d_ff=16, max_context=CTX)


@pytest.fixture(autouse=True)
def _reset_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model, the JAX model's params)."""
    jm = jllm.TinyDecoder(jllm.DecoderConfig(**CFG))
    tm = tllm.TinyDecoder(tllm.DecoderConfig(**CFG), device="cpu")
    return jm, tm, jm.init_params(seed=0)


@pytest.fixture(scope="module")
def oracle(pair):
    """The JAX greedy oracle, memoized per (prompt, n)."""
    jm, _, params = pair
    memo = {}

    def run(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = list(jllm.greedy_decode_reference(jm, params,
                                                          prompt, n))
        return memo[key]
    return run


def _llm(pair, name, **kw):
    _, tm, params = pair
    kw.setdefault("max_seqs", 2)
    srv = tllm.LLMServer(tm, params, name=name, block_size=BS,
                         max_context=CTX, device="cpu", **kw)
    srv.warmup()
    srv.start()
    return srv


def _assert_kv_clean(srv):
    eng = srv.engine
    assert eng.cache.allocator.num_used == 0
    assert eng.cache.check(live_block_ids=[])


def _resolve_all(futs, timeout=30):
    results, errors = [], []
    for f in futs:
        try:
            results.append(f.result(timeout=timeout))
        except BaseException as exc:
            errors.append(exc)
    return results, errors


def _wait_stopped(srv):
    deadline = time.monotonic() + 10
    while srv.running and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not srv.running


def _wait_tokens(srv, n):
    deadline = time.monotonic() + 30
    while (srv.stats()["tokens_generated"] < n
           and time.monotonic() < deadline):
        time.sleep(0.005)
    assert srv.stats()["tokens_generated"] >= n


# ---------------------------------------------------- the LLM matrix --
def test_llm_prefill_poison_isolated(pair, oracle):
    """A poison prompt (prefill raises) fails only ITS Future with the
    original exception; the other sequence decodes to the oracle."""
    srv = _llm(pair, "tc_pois")
    faults.script("llm.prefill", [ValueError("poison prompt")])
    f_bad = srv.submit([1, 2, 3], 4)
    f_ok = srv.submit([2, 3], 4)
    with pytest.raises(ValueError, match="poison prompt"):
        f_bad.result(timeout=30)
    assert f_ok.result(timeout=30).tokens == oracle([2, 3], 4)
    srv.shutdown()
    assert srv.stats()["poison_isolated"] == 1
    _assert_kv_clean(srv)


def test_llm_decode_transient_bitexact_zero_recompiles(pair, oracle):
    """One injected decode raise: the bisect re-dispatches the same
    rung; streams equal the oracle and nothing is built or captured."""
    srv = _llm(pair, "tc_trans")
    prompts = [[1, 2], [3, 4, 5]]
    with serving.CompileCounter() as cc:
        faults.script("llm.decode", [RuntimeError("transient")])
        futs = [srv.submit(p, 6) for p in prompts]
        res = [f.result(timeout=60) for f in futs]
    srv.shutdown()
    assert cc.count == 0
    for p, r in zip(prompts, res):
        assert r.tokens == oracle(p, 6)
    _assert_kv_clean(srv)


def test_llm_decode_poison_isolated(pair, oracle):
    """Three scripted decode raises (top dispatch, the half, the leaf)
    while both rows share the pack, parked first on a gate: exactly one
    sequence fails with the original exception, the other finishes with
    the oracle's stream."""
    srv = _llm(pair, "tc_dpois")
    gate = faults.block_at("llm.decode")
    prompts = [[1, 2, 3], [4, 5]]
    f1 = srv.submit(prompts[0], 12)
    f2 = srv.submit(prompts[1], 12)
    assert gate.wait_reached(30)
    faults.script("llm.decode", [RuntimeError("poison-decode")] * 3)
    gate.release()
    outcomes = []
    for f in (f1, f2):
        try:
            outcomes.append(f.result(timeout=60))
        except RuntimeError as e:
            outcomes.append(e)
    srv.shutdown()
    poisoned = [r for r in outcomes if isinstance(r, RuntimeError)]
    finished = [(p, r) for p, r in zip(prompts, outcomes)
                if not isinstance(r, RuntimeError)]
    assert len(poisoned) == 1 and len(finished) == 1
    assert "poison-decode" in str(poisoned[0])
    p, r = finished[0]
    assert r.tokens == oracle(p, 12)
    assert srv.stats()["poison_isolated"] == 1
    _assert_kv_clean(srv)


def test_llm_worker_death_resolves_everything(pair):
    """InjectedCrash in the engine loop: every Future resolves, no block
    leaks, later submits raise ServerClosed."""
    srv = _llm(pair, "tc_death")
    faults.crash_at_point("llm.worker", nth=2)
    futs = [srv.submit([1 + i, 2], 10) for i in range(3)]
    results, errors = _resolve_all(futs)
    assert len(results) + len(errors) == 3
    assert all(isinstance(e, ServerClosed) for e in errors)
    faults.reset()
    _wait_stopped(srv)
    with pytest.raises(ServerClosed):
        srv.submit([1], 1)
    _assert_kv_clean(srv)


def test_llm_queue_overflow_and_drain_under_load(pair):
    """Bounded admission and a drain deadline under load: shed vs
    evicted vs served is deterministic and each request is counted
    once."""
    srv = _llm(pair, "tc_full", max_seqs=1, max_queue=2)
    gate = faults.block_at("llm.decode")
    f_run = srv.submit([1, 2, 3], 20)
    assert gate.wait_reached(30)
    w1 = srv.submit([2, 3], 5)
    w2 = srv.submit([3, 4], 5)
    with pytest.raises(Overloaded) as ei:
        srv.submit([4, 5], 5)
    assert ei.value.reason == "queue_full"
    with pytest.raises(DeadlineExceededError):
        srv.submit([4, 5], 5, deadline_ms=0)
    done = threading.Event()

    def _shutdown():
        srv.shutdown(drain=True, deadline_ms=0.0)
        done.set()
    threading.Thread(target=_shutdown, daemon=True).start()
    gate.release()
    assert done.wait(60)
    outcomes = {"evicted": 0, "served": 0}
    for f in (f_run, w1, w2):
        try:
            f.result(timeout=10)
            outcomes["served"] += 1
        except SequenceEvictedError as e:
            assert e.reason == "drain_deadline"
            outcomes["evicted"] += 1
    assert outcomes["evicted"] + outcomes["served"] == 3
    assert outcomes["evicted"] >= 2
    st = srv.stats()
    assert st["shed"] == {"queue_full": 1}
    assert st["deadline_expired"] == 1
    assert (st["requests_completed"] + st["requests_evicted"]
            + st["requests_failed"] == st["requests_submitted"])
    _assert_kv_clean(srv)


def test_llm_deadline_expires_waiting_and_running(pair):
    """A waiting sequence whose deadline expires dies before any
    prefill; a running one is evicted typed with its partial tokens."""
    srv = _llm(pair, "tc_dl", max_seqs=1)
    gate = faults.block_at("llm.decode")
    f_run = srv.submit([1, 2, 3], 20, deadline_ms=150.0)
    assert gate.wait_reached(30)
    f_wait = srv.submit([2, 3], 5, deadline_ms=50.0)
    time.sleep(0.2)
    gate.release()
    faults.reset()
    with pytest.raises(DeadlineExceededError) as e_run:
        f_run.result(timeout=60)
    with pytest.raises(DeadlineExceededError) as e_wait:
        f_wait.result(timeout=60)
    assert len(e_run.value.tokens) >= 1
    assert e_wait.value.tokens == []
    srv.shutdown()
    assert srv.stats()["deadline_expired"] == 2
    _assert_kv_clean(srv)


def test_llm_generate_timeout_cancels_sequence(pair, oracle):
    """generate(timeout=) cancels the sequence: blocks and slot come
    back, the error carries partial tokens, the server keeps serving."""
    srv = _llm(pair, "tc_cancel")
    faults.delay_at("llm.decode", 0.04)
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceededError) as ei:
        srv.generate([1, 2, 3], 20, timeout=0.1)
    assert time.monotonic() - t0 >= 0.1
    assert ei.value.reason == "timeout"
    assert len(ei.value.tokens) < 20
    faults.reset()
    assert srv.generate([4, 5], 4, timeout=60).tokens == oracle([4, 5], 4)
    srv.shutdown()
    assert srv.stats()["requests_evicted"] >= 1
    _assert_kv_clean(srv)


def test_llm_breaker_trips_on_persistent_prefill_failure(pair, oracle):
    """Every prefill raises: the breaker opens and submits fail fast;
    after the cooldown a healthy probe closes it."""
    srv = _llm(pair, "tc_brk", breaker_threshold=2,
               breaker_cooldown_ms=50)
    faults.script("llm.prefill", [RuntimeError("backend down")] * 2)
    for i in range(2):
        with pytest.raises(RuntimeError, match="backend down"):
            srv.submit([1 + i, 2], 4).result(timeout=30)
    deadline = time.monotonic() + 10
    while (srv.stats()["breaker_state"] != 1
           and time.monotonic() < deadline):
        time.sleep(0.005)
    assert srv.stats()["breaker_state"] == 1
    with pytest.raises(CircuitOpenError):
        srv.submit([1], 2)
    assert srv.stats()["shed"]["breaker_open"] == 1
    faults.reset()
    time.sleep(0.12)
    assert srv.generate([3, 4], 3, timeout=60).tokens == oracle([3, 4], 3)
    srv.shutdown()
    assert srv.stats()["breaker_state"] == 0
    _assert_kv_clean(srv)


def test_llm_breaker_stays_open_while_decode_succeeds(pair):
    """Decode successes of admitted sequences do not close an open
    breaker: only a probe after the cooldown may."""
    srv = _llm(pair, "tc_brk2", breaker_threshold=2,
               breaker_cooldown_ms=60000)
    gate = faults.block_at("llm.decode")
    f_live = srv.submit([1, 2, 3], CTX - 8)
    assert gate.wait_reached(30)
    gate.release()
    faults.script("llm.prefill", [RuntimeError("backend down")] * 2)
    for i in range(2):
        with pytest.raises(RuntimeError, match="backend down"):
            srv.submit([2 + i, 3], 4).result(timeout=30)
    deadline = time.monotonic() + 10
    while (srv.stats()["breaker_state"] != 1
           and time.monotonic() < deadline):
        time.sleep(0.005)
    assert srv.stats()["breaker_state"] == 1
    tok0 = srv.stats()["tokens_generated"]
    _wait_tokens(srv, min(tok0 + 3, CTX - 8))
    with pytest.raises(CircuitOpenError):
        srv.submit([5, 6], 2)
    assert srv.stats()["breaker_state"] == 1
    srv.shutdown(drain=True, deadline_ms=0.0)
    try:
        f_live.result(timeout=10)
    except ServingError:
        pass
    _assert_kv_clean(srv)


def test_llm_preemption_mid_drain_under_injected_latency(pair):
    """A PreemptionGuard on SIGUSR1 drains with deadline 0 while each
    decode is slowed by 20 ms: every Future resolves served or evicted
    with its partial tokens, and the pool is clean."""
    guard = PreemptionGuard(signals=(signal.SIGUSR1,)).install()
    try:
        srv = _llm(pair, "tc_preempt")
        srv.attach_preemption_guard(guard, poll_s=0.01, deadline_ms=0.0)
        faults.delay_at("llm.decode", 0.02)
        futs = [srv.submit([1 + i, 2], CTX - 8) for i in range(4)]
        _wait_tokens(srv, 2)
        os.kill(os.getpid(), signal.SIGUSR1)
        results, errors = _resolve_all(futs, timeout=60)
        assert len(results) + len(errors) == 4
        assert all(isinstance(e, SequenceEvictedError) for e in errors)
        assert errors and any(e.tokens for e in errors)
        _wait_stopped(srv)
        _assert_kv_clean(srv)
    finally:
        guard.uninstall()


def _spec_server(pair, name):
    _, tm, params = pair
    draft = tllm.TinyDecoder(tllm.DecoderConfig(**DRAFT_CFG), device="cpu")
    jd = jllm.TinyDecoder(jllm.DecoderConfig(**DRAFT_CFG))
    srv = tllm.LLMServer(tm, params, name=name, max_seqs=2, block_size=BS,
                         max_context=CTX, draft_model=draft,
                         draft_params=jd.init_params(seed=5), spec_k=2,
                         device="cpu")
    srv.warmup()
    srv.start()
    return srv


def test_llm_mid_verify_death_resolves_typed_partial_tokens(pair):
    """The worker dies at the third draft round, holding proposals never
    verified: every Future resolves typed, the speculative blocks come
    back (one free covers both pools) and the pool checks clean."""
    srv = _spec_server(pair, "tc_midverify")
    futs = [srv.submit([1 + i, 2, 3], 20) for i in range(3)]
    _wait_tokens(srv, 3)
    faults.crash_at_point("llm.draft", nth=3)
    typed = served = 0
    for f in futs:
        try:
            f.result(timeout=30)
            served += 1
        except ServingError:
            typed += 1
    assert typed + served == 3 and typed >= 1
    faults.reset()
    _wait_stopped(srv)
    with pytest.raises(ServerClosed):
        srv.submit([1], 1)
    _assert_kv_clean(srv)


def test_llm_drain_mid_verify_evicts_with_partial_tokens(pair):
    """An immediate drain while a draft round is parked: every
    speculative sequence resolves served or evicted with the tokens
    committed so far."""
    srv = _spec_server(pair, "tc_specdrain")
    futs = [srv.submit([1 + i, 2, 3], CTX - 8) for i in range(3)]
    _wait_tokens(srv, 3)
    gate = faults.block_at("llm.draft")
    assert gate.wait_reached(30)
    done = threading.Event()

    def _shutdown():
        srv.shutdown(drain=True, deadline_ms=0.0)
        done.set()
    threading.Thread(target=_shutdown, daemon=True).start()
    gate.release()
    assert done.wait(60)
    faults.reset()
    evicted = partial = served = 0
    for f in futs:
        try:
            f.result(timeout=10)
            served += 1
        except SequenceEvictedError as e:
            assert e.reason == "drain_deadline"
            evicted += 1
            partial += bool(e.tokens)
    assert evicted + served == 3 and evicted >= 1 and partial >= 1
    _assert_kv_clean(srv)


def test_chaos_metrics_land_in_one_exposition(pair):
    """A shed, a deadline and a poison row land in the registry's one
    exposition under the reference's names, which
    ``tools/metrics_dump.py`` parses."""
    srv = _llm(pair, "tc_expo", max_seqs=1, max_queue=1)
    gate = faults.block_at("llm.decode")
    f1 = srv.submit([1, 2], 6)
    assert gate.wait_reached(30)
    f2 = srv.submit([2, 3], 2)
    with pytest.raises(Overloaded):
        srv.submit([3], 2)
    with pytest.raises(DeadlineExceededError):
        srv.submit([3], 2, deadline_ms=0)
    faults.script("llm.decode", [RuntimeError("row")])
    gate.release()
    _resolve_all([f1, f2])
    srv.shutdown()
    text = get_registry().expose()
    for needed in ("mxtpu_serving_shed_total",
                   "mxtpu_serving_deadline_expired_total",
                   "mxtpu_serving_poison_isolated_total",
                   "mxtpu_serving_breaker_state",
                   "mxtpu_llm_tokens_generated_total",
                   "mxtpu_llm_ttft_seconds_bucket"):
        assert needed in text
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from metrics_dump import parse_exposition
    finally:
        sys.path.pop(0)
    samples = parse_exposition(text)
    assert samples[("mxtpu_serving_shed_total",
                    (("reason", "queue_full"), ("server", "tc_expo")))] \
        == 1.0


def test_llm_worker_death_with_live_shared_blocks(pair):
    srv = _llm(pair, "tc_share_death")
    prefix = list(range(BS))
    srv.submit(prefix + [1], 2).result(timeout=30)
    faults.crash_at_point("llm.worker", nth=2)
    _resolve_all([srv.submit(prefix + [2 + i], 8) for i in range(3)])
    faults.reset()
    _wait_stopped(srv)
    eng = srv.engine
    assert eng.prefix_hits >= 1
    _assert_kv_clean(srv)
    assert eng.cache.allocator.num_free == eng.cache.allocator.num_usable


def test_llm_drain_with_shared_blocks_refcounts_settle(pair):
    srv = _llm(pair, "tc_share_drain")
    prefix = list(range(BS))
    srv.submit(prefix + [1], 2).result(timeout=30)
    gate = faults.block_at("llm.decode")
    f1 = srv.submit(prefix + [2], 20)
    assert gate.wait_reached(30)
    f2 = srv.submit(prefix + [3], 20)
    done = threading.Event()

    def _shutdown():
        srv.shutdown(drain=True, deadline_ms=0.0)
        done.set()
    threading.Thread(target=_shutdown, daemon=True).start()
    gate.release()
    assert done.wait(60)
    results, errors = _resolve_all([f1, f2], timeout=10)
    assert len(results) + len(errors) == 2
    assert all(isinstance(e, SequenceEvictedError) for e in errors)
    assert srv.engine.prefix_hits >= 1
    _assert_kv_clean(srv)


def test_llm_poison_with_shared_prefix_isolated(pair, oracle):
    srv = _llm(pair, "tc_share_pois")
    prefix = list(range(BS))
    srv.submit(prefix + [1], 2).result(timeout=30)
    faults.script("llm.prefill", [ValueError("poison shared prompt")])
    f_bad = srv.submit(prefix + [2], 4)
    f_ok = srv.submit(prefix + [3], 4)
    with pytest.raises(ValueError, match="poison shared prompt"):
        f_bad.result(timeout=30)
    assert f_ok.result(timeout=30).tokens == oracle(prefix + [3], 4)
    srv.shutdown()
    st = srv.stats()
    assert st["poison_isolated"] == 1 and st["prefix_hits"] >= 1
    _assert_kv_clean(srv)


# ----------------------------------- the schedule, held to the reference --
def _lockstep_trace(eng, fmod, prompts, schedule, Sequence, monkeypatch):
    """Step ``eng`` through ``prompts`` (6 tokens each); after the first
    step (every prompt prefilled) arm ``schedule`` on ``llm.decode`` of
    its package's switchboard ``fmod``. Returns (the sequence of checks
    with their outcome, poisoned prompt indices, survivors' streams)."""
    trace = []
    check = fmod.check

    def spy(site):
        try:
            check(site)
        except Exception as exc:
            trace.append((site, repr(exc)))
            raise
        trace.append((site, None))
    monkeypatch.setattr(fmod, "check", spy)
    seqs = [Sequence(p, 6) for p in prompts]
    for s in seqs:
        eng.add(s)
    eng.step()
    fmod.script("llm.decode", list(schedule))
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
        assert steps < 100
    poisoned = sorted(seqs.index(s) for s, _ in eng.pop_poison())
    eng.pop_finished()
    streams = [s.output_tokens() for i, s in enumerate(seqs)
               if i not in poisoned]
    fmod.reset()
    return trace, poisoned, streams


@pytest.mark.parametrize("rows,raises", [(2, 3), (3, 4), (3, 2)])
def test_isolation_consumes_the_schedule_as_the_reference(
        pair, monkeypatch, rows, raises):
    """The reference's and the port's engines on the same prompts, the
    same ``llm.decode`` schedule on each package's switchboard: the same
    checks in the same order with the same raises, the same row poisoned
    (the top dispatch, each failing half and the leaf retry each take
    one check), the same survivors' streams."""
    from mxnet_tpu.resilience import faults as jfaults
    jm, tm, params = pair
    prompts = [[1 + i, 2, 3 + i] for i in range(rows)]
    schedule = [RuntimeError("poison-decode")] * raises
    jeng = jllm.LLMEngine(jm, params, max_seqs=4, block_size=BS,
                          max_context=CTX)
    teng = tllm.LLMEngine(tm, params, max_seqs=4, block_size=BS,
                          max_context=CTX, device="cpu")
    want = _lockstep_trace(jeng, jfaults, prompts, schedule,
                           jllm.Sequence, monkeypatch)
    got = _lockstep_trace(teng, faults, prompts, schedule, tllm.Sequence,
                          monkeypatch)
    assert got == want
    assert sum(1 for _, e in got[0] if e) == raises
    assert got[1] == ([0] if raises > rows else [])


# --------------------------------------------- lifecycle and statusz --
def test_quiesce_resume_and_lifecycle_members(pair, oracle):
    """``quiesce`` stops admission and waits for every admitted Future
    while the server stays warm; ``resume`` re-opens it, capturing and
    building nothing; ``max_context`` / ``running`` / ``admitting``."""
    srv = _llm(pair, "tc_quiesce")
    assert srv.max_context == CTX and srv.running and srv.admitting
    with serving.CompileCounter() as cc:
        futs = [srv.submit([1 + i, 2], 6) for i in range(3)]
        assert srv.quiesce(timeout=60)
        assert all(f.done() for f in futs) and not srv.admitting
        with pytest.raises(ServerClosed, match="quiesced"):
            srv.submit([1], 1)
        srv.resume()
        assert srv.admitting
        assert srv.generate([4, 5], 4, timeout=60).tokens == \
            oracle([4, 5], 4)
    assert cc.count == 0
    gate = faults.block_at("llm.decode")
    f = srv.submit([1, 2, 3], 8)
    assert gate.wait_reached(30)
    assert srv.quiesce(timeout=0.05) is False       # still live
    gate.release()
    assert srv.quiesce(timeout=60)
    f.result(timeout=10)
    srv.shutdown()
    assert not srv.running and not srv.admitting
    _assert_kv_clean(srv)


def _keys(d, depth=2):
    """The nested key sets of a status dict (lists of dicts by their
    first element)."""
    out = {}
    for k, v in d.items():
        if isinstance(v, list) and v and isinstance(v[0], dict):
            v = v[0]
        out[k] = _keys(v, depth - 1) if isinstance(v, dict) and depth \
            else None
    return out


def test_debug_status_keys_match_the_jax_server(pair):
    jm, _, params = pair
    js = jllm.LLMServer(jm, params, name="tc_status_j", max_seqs=2,
                        block_size=BS, max_context=CTX)
    ts = _llm(pair, "tc_status_t")
    js.start()
    gate = faults.block_at("llm.decode")
    f = ts.submit([1, 2, 3], 6)
    assert gate.wait_reached(30)
    tstat = ts.debug_status()
    gate.release()
    f.result(timeout=30)
    faults.reset()
    from mxnet_tpu.resilience import faults as jfaults
    jgate = jfaults.block_at("llm.decode")
    try:
        jf = js.submit([1, 2, 3], 6)
        assert jgate.wait_reached(120)
        jstat = js.debug_status()
        jgate.release()
        jf.result(timeout=120)
    finally:
        jfaults.reset()
    js.shutdown()
    ts.shutdown()
    assert _keys(tstat) == _keys(jstat)
    json.dumps(tstat)
    assert tstat["engine"]["mesh"] is None and tstat["mesh"] is None
    assert tstat["engine"]["sequences"][0]["seq_id"] == f.result().seq_id
    assert tstat["engine"]["programs"]["warmed"]
    assert tstat["engine"]["weights"]["kv_dtype"] == "float32"


def _series(reg, server):
    """{metric name: value or histogram count} of one server's counter
    and histogram series in ``reg`` (time-valued sums and gauges left
    out)."""
    out = {}
    for m in reg.metrics():
        for child in m.children():
            labels = child.labels_dict
            if labels.get("server") != server:
                continue
            key = (m.name, tuple(sorted((k, v) for k, v in labels.items()
                                        if k != "server")))
            if m.type_name == "counter":
                out[key] = child.value
            elif m.type_name == "histogram":
                out[key] = child.count
            else:
                out[key] = "gauge"
    return out


def test_same_traffic_same_series_as_the_jax_server(pair):
    """Sequential requests (one in flight at a time, so both engines
    schedule the same steps), a prefix hit and a tenant tag through a
    JAX and a port server: the same series and equal counts."""
    from mxnet_tpu.observability import get_registry as jreg
    jm, _, params = pair
    js = jllm.LLMServer(jm, params, name="tc_same_j", max_seqs=2,
                        block_size=BS, max_context=CTX)
    js.warmup()
    js.start()
    ts = _llm(pair, "tc_same_t")
    traffic = [(list(range(BS)) + [1], 3, "acme"), ([2, 3], 5, None),
               (list(range(BS)) + [4], 4, "acme"), ([5], 1, "beta")]
    for srv in (js, ts):
        for prompt, n, tenant in traffic:
            srv.generate(prompt, n, timeout=120, tenant=tenant)
        srv.shutdown()
    want, got = _series(jreg(), "tc_same_j"), _series(get_registry(),
                                                      "tc_same_t")
    assert sorted(got) == sorted(want)
    assert got == want
    assert got[("mxtpu_llm_prefix_hit_total", ())] == 1


# ------------------------------------------------ flight and tracing --
@pytest.fixture
def flight(tmp_path):
    fl = get_flightrecorder()
    fl.disable()
    fl.clear()
    fl.enable(out_dir=str(tmp_path))
    yield fl
    fl.enable(ring=flight_ring_capacity())
    fl.disable()
    fl.clear()


def _load_tool(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_under_torch_chaos", os.path.join(REPO, "tools",
                                                  f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_llm_request_timeline_exemplar_and_statusz(pair, flight):
    """One request's events (submit, admit, prefill, step, served) land
    in the ring, its TTFT exemplar joins back to it, the statusz sweep
    carries the engine, and the bundle reads in ``flight_inspect``; the
    tracer's spans nest the step under nothing and the request spans
    export as a valid Chrome trace; nothing builds or captures."""
    tracer = get_tracer()
    tracer.clear()
    tracer.enable()
    srv = _llm(pair, "tc_flight", max_queue=32)
    try:
        with serving.CompileCounter() as cc:
            futs = [srv.submit([1 + i, 2, 3], 3) for i in range(3)]
            for f in futs:
                f.result(timeout=60)
        gate = faults.block_at("llm.decode")
        f = srv.submit([1, 2, 3], 4)
        assert gate.wait_reached(30)
        faults.script("llm.decode", [RuntimeError("once")])
        gate.release()
        f.result(timeout=60)
    finally:
        srv.shutdown()
        tracer.disable()
    assert cc.count == 0
    events = flight.snapshot()
    by_req = {}
    for e in events:
        if e["req"]:
            by_req.setdefault(e["req"], []).append(e["kind"])
    reqs = {f"llm:{f.result().seq_id}" for f in futs}
    for r in reqs:
        assert {"llm.submit", "llm.admit", "llm.prefill",
                "llm.served"} <= set(by_req[r])
    assert any(e["kind"] == "llm.step" for e in events)
    exm = collect(get_registry(), ("mxtpu_llm_ttft_seconds",))
    ttft_reqs = {e["req"] for row in exm.get("mxtpu_llm_ttft_seconds", [])
                 if row["labels"].get("server") == "tc_flight"
                 for bkt in row["buckets"].values() for e in bkt}
    assert ttft_reqs & reqs
    bundle = flight.dump(trigger="manual", reason="port e2e")
    fi = _load_tool("flight_inspect")
    assert fi.check(bundle) == []
    out = fi.render_request(bundle, sorted(reqs)[0])
    assert "llm.admit" in out and "llm.served" in out
    status = json.load(open(os.path.join(bundle, "status.json")))
    assert status["llm:tc_flight"]["kind"] == "llm"
    spans = tracer.snapshot()
    names = [s["name"] for s in spans]
    assert names.count("mxtpu.llm.request") == 4
    assert "mxtpu.llm.step" in names and "mxtpu.llm.isolate" in names
    step_ids = {s["span_id"] for s in spans if s["name"] == "mxtpu.llm.step"}
    assert all(s["parent_id"] in step_ids for s in spans
               if s["name"] == "mxtpu.llm.isolate")
    assert validate_chrome_trace(tracer.to_chrome_trace()) == len(spans)
    tracer.clear()


def test_worker_death_dumps_a_crash_bundle(pair, flight, tmp_path):
    srv = _llm(pair, "tc_crash_bundle")
    faults.crash_at_point("llm.worker", nth=2)
    _resolve_all([srv.submit([1 + i, 2], 6) for i in range(2)])
    faults.reset()
    _wait_stopped(srv)
    bundles = [d for d in os.listdir(tmp_path) if d.endswith("_crash")]
    assert len(bundles) == 1
    b = os.path.join(tmp_path, bundles[0])
    man = json.load(open(os.path.join(b, "MANIFEST.json")))
    assert "InjectedCrash" in man["reason"]
    assert man["extra"]["server"] == "tc_crash_bundle"
    assert _load_tool("flight_inspect").check(b) == []
    _assert_kv_clean(srv)


def test_off_mode_records_nothing(pair):
    fl, tr = get_flightrecorder(), get_tracer()
    assert not fl.enabled and not tr.enabled
    before, spans = fl.stats()["recorded"], tr.stats()["started"]
    srv = _llm(pair, "tc_off")
    srv.generate([1, 2], 4, timeout=60)
    srv.shutdown()
    assert fl.stats()["recorded"] == before
    assert tr.stats()["started"] == spans


# ------------------------------------------------------------ adapters --
def test_worker_death_with_live_adapters_settles_refcounts(pair):
    _, tm, params = pair
    L, D = CFG["num_layers"], CFG["d_model"]
    bank = AdapterBank(L, D, max_adapters=4, page_rank=4, device="cpu")
    rng = np.random.RandomState(1)
    for name, rank in (("ada", 4), ("bob", 8)):
        bank.publish(name, (rng.randn(L, 4, D, rank) * 0.05).astype(
            np.float32), (rng.randn(L, 4, rank, D) * 0.05).astype(
            np.float32))
    srv = _llm(pair, "tc_adapters_chaos", max_seqs=4, adapter_bank=bank)
    try:
        faults.crash_at_point("llm.worker", nth=2)
        futs = [srv.submit([1 + i, 2, 3], 10, adapter=ad)
                for i, ad in enumerate(["ada", "bob", None, "ada"])]
        _resolve_all(futs)
    finally:
        faults.reset()
    _wait_stopped(srv)
    with pytest.raises(ServerClosed):
        srv.submit([1], 1, adapter="ada")
    st = bank.stats()
    assert st["in_use"] == 0 and st["detached"] == 0
    assert bank.check()
    _assert_kv_clean(srv)

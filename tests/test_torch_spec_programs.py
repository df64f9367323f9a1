"""PyTorch port, speculative decoding's programs: the verify step at
``spec_k = 2`` (``_StepProgram`` over ``_make_step_fn``) and the draft
round (over ``_make_draft_fn``) of ``mxnet_tpu_torch``'s ``LLMEngine``,
one rung at a time, against the JAX package's ``_make_step_fn(model, 2,
sampled)`` and ``_make_draft_fn`` on the CPU, where the same functions
the card captures run eagerly on the same static buffers.

- Tokens and accepted counts are held exactly on rows whose outcome no
  noise decides (greedy, or ``top_k`` 1, where the target's distribution
  is one token); the two packages' noise generators differ by design.
- The draft's adjusted probabilities are held within ``PROB_TOL =
  2e-4``: a softmax of logits that agree within the 1e-4 of
  ``tests/test_torch_llm.py``, at temperature 0.7 or more.
- A host-sync guard (every tensor-to-host read patched to raise) runs
  both programs at every rung, as ``tests/test_torch_step_program.py``
  does the step at ``spec_k = 0``.
- The sampling transform over a verify window against the reference's.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu.serving import llm as jllm  # noqa: E402
from mxnet_tpu.serving.llm.engine import (  # noqa: E402
    _make_draft_fn as jax_make_draft_fn, _make_step_fn as jax_make_step_fn)
from mxnet_tpu_torch.serving import llm as tllm  # noqa: E402

torch.set_num_threads(2)

CFG = dict(vocab_size=48, d_model=32, num_layers=2, num_heads=2,
           d_ff=64, max_context=64)
BS, S, K = 8, 2, 2
PROB_TOL = 2e-4


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX draft, numpy params, numpy draft params)."""
    jm = jllm.TinyDecoder(jllm.DecoderConfig(**CFG))
    jd = jllm.TinyDecoder(jllm.DecoderConfig(**dict(CFG, num_layers=1)))
    npp = jm.init_params(seed=0)
    return jm, jd, npp, dict(npp, layers=list(npp["layers"][:1]))


@pytest.fixture(scope="module")
def spec_engine(pair):
    """A port engine with the target truncated to one layer as its
    draft, on the CPU."""
    _, _, npp, dp = pair
    tm = tllm.TinyDecoder(tllm.DecoderConfig(**CFG), device="cpu")
    td = tllm.TinyDecoder(tllm.DecoderConfig(**dict(CFG, num_layers=1)),
                          device="cpu")
    return tllm.LLMEngine(tm, npp, max_seqs=S, block_size=BS,
                          draft_model=td, draft_params=dp, spec_k=K,
                          device="cpu")


# ------------------------------------------- the programs, one rung --
def _spec_batch(t, mb, kind, sampled, seed):
    """A seeded batch at rung (t, mb) for a verify step (``kind``
    "step": rows verifying 0..K proposals or writing a prompt chunk) or
    a draft round ("draft": feeds of 1..16 tokens), packed in a random
    row order at random depths over fragmented tables; on a sampled
    rung each row greedy, ``top_k`` 1, ``top_p`` 0.9 or fully random
    (the first greedy or ``top_k`` 1).
    Returns the batch fields as numpy and the live rows."""
    rng = np.random.RandomState(seed)
    n_blocks = 1 + S * (CFG["max_context"] // BS)
    b = dict(tokens=np.zeros(t, np.int32), positions=np.zeros(t, np.int32),
             seq_ids=np.zeros(t, np.int32), valid=np.zeros(t, np.int32),
             tables=np.zeros((S, mb), np.int32),
             top_k=np.zeros(S, np.int32),
             seeds=rng.randint(0, 2 ** 31, size=S).astype(np.int32),
             counters=rng.randint(0, 1000, size=S).astype(np.int32),
             temperature=np.zeros(S, np.float32),
             top_p=np.ones(S, np.float32))
    if kind == "step":
        b.update(win_idx=np.zeros((S, K + 1), np.int32),
                 draft_tokens=rng.randint(0, CFG["vocab_size"],
                                          size=(S, K)).astype(np.int32),
                 n_draft=np.zeros(S, np.int32))
    else:
        b["last_idx"] = np.zeros(S, np.int32)
    ids = iter(rng.permutation(np.arange(1, n_blocks)))
    off, live = 0, []
    for i in rng.permutation(S):
        left = t - off
        if left <= 0:
            break
        k = 0
        if kind == "step" and rng.rand() < 0.7:
            k = int(rng.randint(0, K + 1))
            n = k + 1
        else:
            n = int(rng.randint(1, 17))
        n = min(n, left, mb * BS)
        k = min(k, n - 1)
        live.append(int(i))
        ctx = rng.randint(0, mb * BS - n + 1)
        sl = slice(off, off + n)
        b["tokens"][sl] = rng.randint(0, CFG["vocab_size"], size=n)
        b["positions"][sl] = ctx + np.arange(n)
        b["seq_ids"][sl] = i
        b["valid"][sl] = 1
        if kind == "step":
            b["win_idx"][i] = np.clip(off + n - 1 - k + np.arange(K + 1),
                                      0, t - 1)
            b["n_draft"][i] = k
        else:
            b["last_idx"][i] = off + n - 1
        nb = -(-(ctx + n) // BS)
        b["tables"][i, :nb] = [next(ids) for _ in range(nb)]
        if sampled:
            # the first row is one the reference's outcome decides
            mode = rng.randint(2 if len(live) == 1 else 4)
            b["temperature"][i] = (0.0, 0.8, 0.7, 1.0)[mode]
            b["top_k"][i] = 1 if mode == 1 else 0
            b["top_p"][i] = 0.9 if mode == 2 else 1.0
        off += n
    b["positions"][off:] = rng.randint(0, CFG["max_context"], size=t - off)
    return b, sorted(live)


def _pools(layers, seed):
    rng = np.random.RandomState(seed)
    shape = (layers, 1 + S * (CFG["max_context"] // BS), BS,
             CFG["num_heads"], CFG["d_model"] // CFG["num_heads"])
    return [rng.randn(*shape).astype(np.float32) for _ in range(2)]


def _load(prog, cache, b, pools):
    bufs = prog.bufs
    for name in bufs._INT_FIELDS + bufs._F32_FIELDS:
        getattr(bufs, name)[...] = b[name]
    for dst, src in zip(cache.pools(), pools):
        dst.copy_(torch.from_numpy(src))


_JAX = {}


def _jax_fn(kind, model, sampled):
    key = (kind, sampled)
    if key not in _JAX:
        make = (jax_make_step_fn(model, K, sampled) if kind == "step"
                else jax_make_draft_fn(model, sampled))
        _JAX[key] = jax.jit(make)
    return _JAX[key]


def _rungs(kind):
    ts = (6, 19, 32) if kind == "step" else (4, 19, 32)
    return [(t, mb, s) for t in ts for mb in (4, 8) for s in (False, True)]


def _rung_id(r):
    return f"t{r[0]}-mb{r[1]}-{'sampled' if r[2] else 'greedy'}"


def _held(b, live):
    """Rows whose outcome no noise decides: greedy, or top_k 1."""
    return [i for i in live if b["temperature"][i] == 0
            or b["top_k"][i] == 1]


@pytest.mark.parametrize("rung", _rungs("step"), ids=_rung_id)
def test_verify_step_matches_the_reference_step(pair, spec_engine, rung):
    """One rung of the ``spec_k = 2`` verify step against the
    reference's ``_make_step_fn(model, 2, sampled)`` on the same pools,
    batch, proposals (some the target's own argmax, so accepted) and
    draft probabilities: tokens and accepted counts identical on every
    held row."""
    jm, _, npp, _ = pair
    eng = spec_engine
    assert tuple(eng._t_buckets) == (6, 19, 32)
    t, mb, sampled = rung
    seed = _rungs("step").index(rung)
    b, live = _spec_batch(t, mb, "step", sampled, seed)
    pools = _pools(CFG["num_layers"], seed + 50)
    rng = np.random.RandomState(seed + 100)
    probs = rng.dirichlet(np.ones(CFG["vocab_size"]),
                          size=(S, K)).astype(np.float32)
    # proposals that agree with the target where a coin says so
    arg = eng.model.decode_flat(
        eng.params, *(torch.from_numpy(b[k]) for k in (
            "tokens", "positions", "seq_ids", "valid")),
        *(torch.from_numpy(p.copy()) for p in pools),
        torch.from_numpy(b["tables"])).argmax(-1).numpy()
    for i in live:
        for j in range(K):
            if rng.rand() < 0.7:
                b["draft_tokens"][i, j] = arg[b["win_idx"][i, j]]
    prog = eng._program(t, mb, sampled)
    _load(prog, eng.cache, b, pools)
    eng._draft_probs.copy_(torch.from_numpy(probs))
    toks, n_acc = prog.run()
    jt, jn, _, _ = _jax_fn("step", jm, sampled)(
        npp, jnp.asarray(pools[0]), jnp.asarray(pools[1]),
        *(jnp.asarray(b[k]) for k in (
            "tokens", "positions", "seq_ids", "valid", "tables",
            "win_idx", "draft_tokens")),
        jnp.asarray(probs), jnp.asarray(b["n_draft"]),
        *(jnp.asarray(b[k]) for k in ("temperature", "top_k", "top_p",
                                      "seeds", "counters")))
    jt, jn = np.asarray(jt), np.asarray(jn)
    held = _held(b, live)
    assert held
    assert n_acc[held].tolist() == jn[held].tolist()
    for i in held:
        assert toks[i, :n_acc[i] + 1].tolist() == \
            jt[i, :jn[i] + 1].tolist()
    assert all(0 <= n_acc[i] <= b["n_draft"][i] for i in live)


@pytest.mark.parametrize("rung", _rungs("draft"), ids=_rung_id)
def test_draft_round_matches_the_reference_draft(pair, spec_engine, rung):
    """One rung of the draft round against the reference's
    ``_make_draft_fn`` on the same pools and batch: proposals identical
    on every held row, and on a sampled rung every live row's adjusted
    probabilities within PROB_TOL."""
    _, jd, _, dp = pair
    eng = spec_engine
    assert tuple(eng._draft_t_buckets) == (4, 19, 32)
    t, mb, sampled = rung
    seed = 200 + _rungs("draft").index(rung)
    b, live = _spec_batch(t, mb, "draft", sampled, seed)
    pools = _pools(1, seed + 50)
    prog = eng._draft_program(t, mb, sampled)
    _load(prog, eng.draft_cache, b, pools)
    eng._draft_round_probs.zero_()
    tok = prog.run()
    jtok, jprobs, _, _ = _jax_fn("draft", jd, sampled)(
        dp, jnp.asarray(pools[0]), jnp.asarray(pools[1]),
        *(jnp.asarray(b[k]) for k in (
            "tokens", "positions", "seq_ids", "valid", "tables",
            "last_idx", "temperature", "top_k", "top_p", "seeds",
            "counters")))
    held = _held(b, live)
    assert tok[held].tolist() == np.asarray(jtok)[held].tolist()
    if sampled:
        got = eng._draft_round_probs.numpy()[live]
        np.testing.assert_allclose(got, np.asarray(jprobs)[live],
                                   atol=PROB_TOL, rtol=0)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


_SYNCS = ("item", "cpu", "tolist", "numpy", "__bool__", "__int__",
          "__float__")


@pytest.mark.parametrize("rung", [("step",) + r for r in _rungs("step")]
                         + [("draft",) + r for r in _rungs("draft")],
                         ids=lambda r: f"{r[0]}-{_rung_id(r[1:])}")
def test_spec_programs_read_nothing_back(spec_engine, monkeypatch, rung):
    """The verify step and the draft round of every rung (what the card
    captures) run to their end with every tensor-to-host read patched to
    raise, and write what they write unpatched."""
    eng = spec_engine
    kind, t, mb, sampled = rung
    b, _ = _spec_batch(t, mb, kind, sampled, 300 + t + mb)
    if kind == "step":
        prog, cache = eng._program(t, mb, sampled), eng.cache
        pools = _pools(CFG["num_layers"], 7)
    else:
        prog, cache = eng._draft_program(t, mb, sampled), eng.draft_cache
        pools = _pools(1, 7)
    _load(prog, cache, b, pools)
    prog.fn()
    want = prog._out.clone()
    _load(prog, cache, b, pools)
    prog._out.zero_()

    def host_read(name):
        def raise_(*a, **k):
            raise AssertionError(f"the program read a tensor back: {name}")
        return raise_
    for name in _SYNCS:
        monkeypatch.setattr(torch.Tensor, name, host_read(name))
    prog.fn()
    monkeypatch.undo()
    assert torch.equal(prog._out, want)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (1, 1.0), (5, 1.0),
                                         (0, 0.8), (7, 0.6)])
def test_adjusted_log_probs_over_a_verify_window_match_jax(top_k, top_p):
    """(Tolerance 1e-6: the same f32 softmax and cumulative sums in
    another order.) The sampling transform over a ``[S, K+1, V]`` verify window with
    per-row ``[S, 1]`` knobs (as the sampled verify applies it) gives
    the reference's distribution at every window position."""
    from mxnet_tpu.serving.llm import sampling as js
    from mxnet_tpu_torch.serving.llm import sampling as ts
    rng = np.random.RandomState(top_k * 10 + int(top_p * 10))
    logits = (3 * rng.randn(4, K + 1, CFG["vocab_size"])).astype(
        np.float32)
    temp = np.array([0.7, 1.0, 1.3, 0.9], np.float32)[:, None]
    tk = np.full((4, 1), top_k, np.int32)
    tp = np.full((4, 1), top_p, np.float32)
    want = np.exp(np.asarray(js.adjusted_log_probs(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(tk),
        jnp.asarray(tp))))
    got = torch.exp(ts.adjusted_log_probs(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(tk), torch.from_numpy(tp))).numpy()
    # (a tail token whose cumulative mass rounds onto top_p = 1 may stay
    # in one and not the other: it carries less than the tolerance)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)

"""PyTorch port, the serving step program: ``LLMEngine``'s per-rung
step (``_StepProgram`` over ``_make_step_fn``; on CUDA one graph replay)
against the JAX package's ``_make_step_fn``, on the CPU, where the same
step function runs eagerly on the same static buffers.

- every (packed length, table width, greedy|sampled) rung of a small
  engine against the reference's step program on the same pools and
  a seeded mixed batch;
- a host-sync guard: the step function, the region captured on the
  card, reads nothing back to the host;
- the launch accounting of a captured graph, with a stub graph.

Tolerances, each with its reason: ``STEP_TOL = 1e-4`` for logits (as
``tests/test_torch_llm.py``: the paged attention and the matmuls sum in
another order, two layers deep); ``KV_TOL = 1e-5`` for the K/V the step
writes (one layer-norm and one projection from equal inputs, then layer
2's from inputs within float noise). Tokens are held exactly: greedy
rows take the argmax; sampled rows either keep one candidate (``top_k``
1, or a ``top_p`` below every second probability), so the port's
Philox noise and the reference's threefry noise pick the same token, or
draw with full noise and are held against the port's accept rule on the
reference's logits (the two generators' bits differ by design).
"""
import collections
import contextlib
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
    _make_step_fn as jax_make_step_fn)
from mxnet_tpu_torch import kernels  # noqa: E402
from mxnet_tpu_torch.convert import params_from_numpy  # noqa: E402
from mxnet_tpu_torch.serving import llm as tllm  # noqa: E402
from mxnet_tpu_torch.serving.llm import engine as tengine  # noqa: E402
from mxnet_tpu_torch.serving.llm.sampling import (  # noqa: E402
    TAG_SAMPLE, row_keys, sample_tokens)
from mxnet_tpu_torch.serving.telemetry import compile_count  # noqa: E402

torch.set_num_threads(2)

STEP_TOL = 1e-4
KV_TOL = 1e-5
CFG = dict(vocab_size=48, d_model=32, num_layers=2, num_heads=2,
           d_ff=64, max_context=64)
BS, S, CHUNK = 8, 4, 8
# the engine's ladders at max_seqs 4, prefill_chunk 8, 64 positions of
# 8-token blocks: all-rows decode, one or two rows mid-prefill, full
# prefill; half and full table width
T_BUCKETS = (4, 11, 18, 32)
MB_WIDTHS = (4, 8)
RUNGS = [(t, mb, sampled) for t in T_BUCKETS for mb in MB_WIDTHS
         for sampled in (False, True)]
RUNG_IDS = [f"t{t}-mb{mb}-{'sampled' if s else 'greedy'}"
            for t, mb, s in RUNGS]


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model, numpy params)."""
    jm = jllm.TinyDecoder(jllm.DecoderConfig(**CFG))
    tm = tllm.TinyDecoder(tllm.DecoderConfig(**CFG), device="cpu")
    return jm, tm, jm.init_params(seed=0)


@pytest.fixture(scope="module")
def engines(models):
    """Port engines on the CPU, float32 and int8 KV + int8 weights (the
    reference's quantized checkpoint, passed through)."""
    jm, tm, npp = models
    out = {"float32": tllm.LLMEngine(tm, npp, max_seqs=S, block_size=BS,
                                     prefill_chunk=CHUNK, device="cpu")}
    out["int8"] = tllm.LLMEngine(
        tm, jllm.quantize_weights(npp, dtype="int8"), max_seqs=S,
        block_size=BS, prefill_chunk=CHUNK, kv_dtype="int8", device="cpu")
    for eng in out.values():
        assert tuple(eng._t_buckets) == T_BUCKETS
        assert tuple(eng._mb_widths) == MB_WIDTHS
    return out


def _batch(t, mb, sampled, seed):
    """A seeded mixed step at rung (t, mb): prefill chunks and decode
    tokens of up to S rows packed in a random row order, at random
    depths over fragmented tables, at least one padded token; on a
    sampled rung each live row greedy, top-k 1, top-p 1e-4 or fully
    random. Returns the batch fields as numpy and the live rows."""
    rng = np.random.RandomState(seed)
    n_blocks = 1 + S * (CFG["max_context"] // BS)
    ns = np.zeros(S, np.int64)
    for i in rng.permutation(S):
        left = t - 1 - ns.sum()
        if left > 0 and rng.rand() < 0.85:
            ns[i] = min(left, 1 if rng.rand() < 0.4
                        else rng.randint(1, CHUNK + 1))
    if not ns.any():
        ns[rng.randint(S)] = 1
    b = dict(tokens=np.zeros(t, np.int32), positions=np.zeros(t, np.int32),
             seq_ids=np.zeros(t, np.int32), valid=np.zeros(t, np.int32),
             tables=np.zeros((S, mb), np.int32),
             win_idx=np.zeros((S, 1), np.int32),
             draft_tokens=np.zeros((S, 0), np.int32),
             n_draft=np.zeros(S, np.int32), top_k=np.zeros(S, np.int32),
             seeds=rng.randint(0, 2 ** 31, size=S).astype(np.int32),
             counters=rng.randint(0, 1000, size=S).astype(np.int32),
             temperature=np.zeros(S, np.float32),
             top_p=np.ones(S, np.float32))
    ids = iter(rng.permutation(np.arange(1, n_blocks)))
    off, live = 0, []
    for i in rng.permutation(S):
        n = int(ns[i])
        if not n:
            continue
        live.append(int(i))
        ctx = rng.randint(0, mb * BS - n + 1)
        sl = slice(off, off + n)
        b["tokens"][sl] = rng.randint(0, CFG["vocab_size"], size=n)
        b["positions"][sl] = ctx + np.arange(n)
        b["seq_ids"][sl] = i
        b["valid"][sl] = 1
        b["win_idx"][i] = off + n - 1
        nb = -(-(ctx + n) // BS)
        b["tables"][i, :nb] = [next(ids) for _ in range(nb)]
        if sampled:
            kind = rng.randint(4)
            b["temperature"][i] = (0.0, 0.8, 0.7, 1.0)[kind]
            b["top_k"][i] = 1 if kind == 1 else 0
            b["top_p"][i] = 1e-4 if kind == 2 else 1.0
        off += n
    # stale entries past the pack, as the engine leaves them
    b["positions"][off:] = rng.randint(0, CFG["max_context"], size=t - off)
    return b, sorted(live)


def _pools(seed, dtype):
    rng = np.random.RandomState(seed + 1)
    shape = (CFG["num_layers"], 1 + S * (CFG["max_context"] // BS), BS,
             CFG["num_heads"], CFG["d_model"] // CFG["num_heads"])
    if dtype == "float32":
        return [rng.randn(*shape).astype(np.float32) for _ in range(2)]
    return ([rng.randint(-127, 128, size=shape).astype(np.int8)
             for _ in range(2)]
            + [rng.uniform(0.005, 0.02, size=shape[:-1]).astype(np.float32)
               for _ in range(2)])


def _load(eng, prog, b, pools):
    for name in tengine._StepBuffers._INT_FIELDS + \
            tengine._StepBuffers._F32_FIELDS:
        getattr(prog.bufs, name)[...] = b[name]
    for dst, src in zip(eng.cache.pools(), pools):
        dst.copy_(torch.from_numpy(src))


_JAX_STEPS = {}


def _jax_step(jm, sampled):
    """The reference's step program and its flat forward, jitted once
    per variant (and traced once per rung's shapes)."""
    if sampled not in _JAX_STEPS:
        step = jax_make_step_fn(jm, 0, sampled)

        def both(params, kp, vp, tokens, positions, seq_ids, valid,
                 tables, *rest):
            logits = jm.decode_flat(params, tokens, positions, seq_ids,
                                    valid, kp, vp, tables)[0]
            return step(params, kp, vp, tokens, positions, seq_ids, valid,
                        tables, *rest), logits
        _JAX_STEPS[sampled] = jax.jit(both)
    return _JAX_STEPS[sampled]


@pytest.mark.parametrize("rung", RUNGS, ids=RUNG_IDS)
def test_step_program_matches_the_reference_step(models, engines, rung):
    """One rung's step program against the reference's ``_make_step_fn``
    on the same pools and batch: every live row's token identical, the
    pack's logits within STEP_TOL and every page the step wrote within
    KV_TOL; pages it did not write untouched."""
    jm, tm, npp = models
    eng = engines["float32"]
    t, mb, sampled = rung
    seed = RUNGS.index(rung)
    b, live = _batch(t, mb, sampled, seed)
    pools = _pools(seed, "float32")
    prog = eng._program(t, mb, sampled)
    _load(eng, prog, b, pools)
    toks, n_acc = prog.run()
    V = CFG["vocab_size"]
    jb = [jnp.asarray(b[k]) for k in ("tokens", "positions", "seq_ids",
                                      "valid", "tables")]
    (jt, jn, jkp, jvp), jlogits = _jax_step(jm, sampled)(
        npp, jnp.asarray(pools[0]), jnp.asarray(pools[1]), *jb,
        jnp.asarray(b["win_idx"]), jnp.zeros((S, 0), jnp.int32),
        jnp.zeros((S, 0, V), jnp.float32), jnp.zeros(S, jnp.int32),
        *(jnp.asarray(b[k]) for k in ("temperature", "top_k", "top_p",
                                      "seeds", "counters")))
    jt, jn, jlogits = np.asarray(jt), np.asarray(jn), np.asarray(jlogits)
    free = [i for i in live if b["temperature"][i] == 1.0]
    held = [i for i in live if i not in free]
    assert toks[held, 0].tolist() == jt[held, 0].tolist()
    assert n_acc[live].tolist() == jn[live].tolist() == [0] * len(live)
    if free:
        # fully random rows: the port's accept rule on the reference's
        # logits draws the port's token
        win = torch.from_numpy(jlogits[b["win_idx"][free, 0]])
        f = torch.tensor(free)
        keys = row_keys(torch.from_numpy(b["seeds"])[f],
                        torch.from_numpy(b["counters"])[f], TAG_SAMPLE)
        want = sample_tokens(win, torch.from_numpy(b["temperature"])[f],
                             torch.from_numpy(b["top_k"])[f],
                             torch.from_numpy(b["top_p"])[f], keys)
        assert toks[free, 0].tolist() == want.tolist()
    n = int(b["valid"].sum())
    tp = params_from_numpy(npp, "cpu")
    got = tm.decode_flat(tp, *(torch.from_numpy(b[k]) for k in (
        "tokens", "positions", "seq_ids", "valid")),
        torch.from_numpy(pools[0]), torch.from_numpy(pools[1]),
        torch.from_numpy(b["tables"]))
    np.testing.assert_allclose(got[:n].numpy(), jlogits[:n], atol=STEP_TOL,
                               rtol=0)
    written = sorted({int(b["tables"][s, p // BS]) for s, p in zip(
        b["seq_ids"][:n], b["positions"][:n])})
    for mine, theirs, orig in ((eng.cache.k_pages, jkp, pools[0]),
                               (eng.cache.v_pages, jvp, pools[1])):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(mine[:, written].numpy(),
                                   theirs[:, written], atol=KV_TOL, rtol=0)
        rest = np.setdiff1d(np.arange(1, orig.shape[1]), written)
        assert np.array_equal(mine[:, rest].numpy(), orig[:, rest])


_SYNCS = ("item", "cpu", "tolist", "numpy", "__bool__", "__int__",
          "__float__")


@pytest.mark.parametrize("variant", ["float32", "int8"])
@pytest.mark.parametrize("rung", RUNGS, ids=RUNG_IDS)
def test_step_function_reads_nothing_back(engines, monkeypatch, variant,
                                          rung):
    """The step function of every rung (what the card captures) runs to
    its end with every tensor-to-host read patched to raise: no
    ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()`` and no tensor
    taken as a bool, int or float."""
    eng = engines[variant]
    t, mb, sampled = rung
    seed = 100 + RUNGS.index(rung)
    b, _ = _batch(t, mb, sampled, seed)
    prog = eng._program(t, mb, sampled)
    _load(eng, prog, b, _pools(seed, variant))
    prog.fn()                       # unpatched: the expected output
    want = prog._out.clone()
    _load(eng, prog, b, _pools(seed, variant))
    prog._out.zero_()

    def host_read(name):
        def raise_(*a, **k):
            raise AssertionError(f"the step read a tensor back: {name}")
        return raise_
    for name in _SYNCS:
        monkeypatch.setattr(torch.Tensor, name, host_read(name))
    prog.fn()
    monkeypatch.undo()
    assert torch.equal(prog._out, want)


class _StubGraph:
    def replay(self):
        pass


@contextlib.contextmanager
def _stub_cuda(monkeypatch):
    """``torch.cuda``'s stream and graph calls as no-ops: the capture's
    Python runs once, as it does on the card, and nothing launches."""
    class Stream:
        device = torch.device("cpu")

        def __init__(self, *a, **k):
            pass

        def wait_stream(self, other):
            pass
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, **k: contextlib.nullcontext())
    yield
    monkeypatch.undo()


def test_capture_tallies_launches_and_each_replay_adds_them(monkeypatch):
    """A capture's launches go to the graph's tally, not the counters;
    the warm run before it is a launch; each replay adds the tally;
    the capture counts once as a compile."""
    calls = collections.Counter()

    def fn():
        calls["fn"] += 1
        kernels.count_launch("k.a")
        kernels.count_launch("k.a")
        kernels.count_launch("k.b")
    kernels.reset_launch_counts()
    before = compile_count()
    with _stub_cuda(monkeypatch):
        g = kernels.capture(fn, torch.cuda.Stream(), what="fn")
    assert calls["fn"] == 2
    assert g.tally == {"k.a": 2, "k.b": 1}
    assert kernels.launch_counts() == {"k.a": 2, "k.b": 1}
    assert compile_count() == before + 1
    for i in range(1, 4):
        g.replay()
        assert kernels.launch_counts() == {"k.a": 2 + 2 * i, "k.b": 1 + i}
    assert calls["fn"] == 2


def test_a_failed_capture_raises_naming_what(monkeypatch):
    """A capture that fails raises, naming the rung, and leaves no
    tally open behind it: the next launches count."""
    def fn():
        kernels.count_launch("k.c")
        if calls:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        calls.append(1)
    calls = []
    kernels.reset_launch_counts()
    with _stub_cuda(monkeypatch):
        with pytest.raises(RuntimeError, match="the step rung t4mb4_greedy"):
            kernels.capture(fn, torch.cuda.Stream(),
                            what="the step rung t4mb4_greedy")
    kernels.count_launch("k.c")
    assert kernels.launch_counts() == {"k.c": 2}


def test_step_program_replays_its_graph_instead_of_the_step(models,
                                                           monkeypatch):
    """With a graph installed, ``run()`` replays it (adding the
    capture's tally) and never calls the step function; the engine's
    ``programs()`` counts the graph, its replays and the dispatches."""
    jm, tm, npp = models
    eng = tllm.LLMEngine(tm, npp, max_seqs=S, block_size=BS,
                         prefill_chunk=CHUNK, device="cpu")
    prog = eng._program(4, 4, False)
    calls = []
    step = prog.fn
    prog.fn = lambda: (calls.append(1), step(),
                       kernels.count_launch("flat_attention"))
    kernels.reset_launch_counts()
    with _stub_cuda(monkeypatch):
        prog.graph = kernels.capture(prog.fn, torch.cuda.Stream(),
                                     what=str(prog))
    assert calls == [1, 1]
    assert kernels.launch_counts() == {"flat_attention": 1}
    for i in range(2):
        prog.run()
    assert calls == [1, 1]
    assert kernels.launch_counts() == {"flat_attention": 3}
    progs = eng.programs()
    assert (progs["graphs"], progs["replays"], progs["dispatches"]) == \
        (1, 2, 2)
    eng.release_graphs()
    assert eng.programs()["graphs"] == 0

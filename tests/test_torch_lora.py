"""PyTorch port, the LoRA delta (``mxnet_tpu_torch/ops/lora.py``) and the
decoder's ``lora=`` / ``adapter=`` paths, against the JAX package on the
same numpy inputs, on the CPU.

- ``paged_lora_delta`` / ``gather_adapter`` against ``mxnet_tpu.ops.lora``
  (the same einsums: tol 1e-6 absolute on deltas of O(0.1));
- the flat step's form, ``pool_lora_delta`` (one product with the whole
  pool, a page mask, the second product, the scale), against the paged
  form over the same pages (tol 1e-5 of the delta's magnitude: the same
  products, summed in another order), and exactly zero on null rows;
- ``lora_delta`` through the registry and ``nd`` against the JAX op;
- ``TinyDecoder.forward(lora=)`` against the JAX package's (logits tol
  1e-5), ``greedy_decode_reference(lora=)`` (identical streams), and
  ``decode_flat(adapter=)`` against the JAX step on the same pools and
  tables (tol 1e-5);
- ``decode_flat``'s row bits: a base row of a bank's step equals the same
  step without a bank, a row's logits and KV are the same alone and
  packed (the draft's route, ``dense_rows=DENSE_ROWS``), and a resident
  cold adapter whose ``x @ A`` overflows changes no other row's bits;
- the bank refuses factors or an alpha that are not finite.

One JAX model and one port model (vocab 17, d_model 16, 2 layers, the
shapes of ``tests/test_adapters.py``).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from mxnet_tpu.ops import lora as jlora  # noqa: E402
from mxnet_tpu.serving import llm as jllm  # noqa: E402
from mxnet_tpu.serving.adapters import AdapterBank as JBank  # noqa: E402
from mxnet_tpu_torch import nd  # noqa: E402
from mxnet_tpu_torch.convert import params_from_numpy  # noqa: E402
from mxnet_tpu_torch.ops import lora as tlora  # noqa: E402
from mxnet_tpu_torch.ops.registry import get as get_op  # noqa: E402
from mxnet_tpu_torch.serving import llm as tllm  # noqa: E402
from mxnet_tpu_torch.serving.adapters import (  # noqa: E402
    AdapterBank, AdapterError)
from mxnet_tpu_torch.serving.llm.kv_cache import PagedKVCache  # noqa: E402

torch.set_num_threads(2)

VOCAB, BS, CTX, L, D = 17, 8, 32, 2, 16
CFG = dict(vocab_size=VOCAB, d_model=D, num_layers=L, num_heads=2, d_ff=32,
           max_context=CTX)
DELTA_TOL = 1e-6
POOL_REL_TOL = 1e-5
LOGIT_TOL = 1e-5


def _factors(seed, rank, scale=0.05):
    rng = np.random.RandomState(seed)
    a = (rng.randn(L, 4, D, rank) * scale).astype(np.float32)
    b = (rng.randn(L, 4, rank, D) * scale).astype(np.float32)
    return a, b


@pytest.fixture(scope="module")
def models():
    jm = jllm.TinyDecoder(jllm.DecoderConfig(**CFG))
    tm = tllm.TinyDecoder(tllm.DecoderConfig(**CFG), device="cpu")
    npp = tm.init_params_numpy(0)
    return jm, tm, npp, params_from_numpy(npp, "cpu")


@pytest.fixture(scope="module")
def banks():
    """The same adapters published into a JAX bank and a port bank:
    'ada' (rank 4, one page), 'bob' (rank 8, two pages, alpha 4),
    'cal' (rank 2, a zero-padded tail page)."""
    jb = JBank(L, D, max_adapters=4, page_rank=4)
    tb = AdapterBank(L, D, max_adapters=4, page_rank=4, device="cpu")
    for name, seed, rank, alpha in (("ada", 1, 4, None), ("bob", 2, 8, 4.0),
                                    ("cal", 3, 2, None)):
        a, b = _factors(seed, rank)
        assert jb.publish(name, a, b, alpha=alpha) == \
            tb.publish(name, a, b, alpha=alpha)
    return jb, tb


def _huge_factors(seed, rank):
    """Finite factors whose ``x @ A`` overflows: A's entries +-3e38."""
    a, b = _factors(seed, rank)
    return np.sign(a) * np.float32(3e38), b


def _pools(rng, P=5, r=4, Pt=2):
    a = (rng.randn(P, L, 4, D, r) * 0.1).astype(np.float32)
    b = (rng.randn(P, L, 4, r, D) * 0.1).astype(np.float32)
    a[0] = 0
    b[0] = 0
    return a, b


# --------------------------------------------------------- the delta --
@pytest.mark.parametrize("layer,proj", [(0, tlora.PROJ_Q), (1, tlora.PROJ_V),
                                        (1, tlora.PROJ_O)])
def test_paged_delta_and_gather_match_the_jax_package(layer, proj):
    rng = np.random.RandomState(layer * 4 + proj)
    a, b = _pools(rng)
    pages = rng.randint(0, 5, size=(9, 2)).astype(np.int32)
    x = rng.randn(9, D).astype(np.float32)
    scale = rng.rand(9).astype(np.float32)
    ja, jb = jlora.gather_adapter(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(pages), layer, proj)
    ta, tb = tlora.gather_adapter(torch.from_numpy(a), torch.from_numpy(b),
                                  torch.from_numpy(pages), layer, proj)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    want = np.asarray(jlora.paged_lora_delta(jnp.asarray(x), ja, jb,
                                             jnp.asarray(scale)))
    got = tlora.paged_lora_delta(torch.from_numpy(x), ta, tb,
                                 torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(got, want, atol=DELTA_TOL, rtol=0)


@pytest.mark.parametrize("proj", range(4))
def test_pool_form_matches_the_paged_form(proj):
    """The flat step's delta (the whole pool, a page mask) against the
    per-token gathered pages, on tables of distinct pages padded with the
    null page; rows of the null table alone get an exact zero."""
    rng = np.random.RandomState(10 + proj)
    bank = AdapterBank(L, D, max_adapters=3, page_rank=4, device="cpu")
    for name, rank in (("a", 4), ("b", 8), ("c", 3)):
        bank.publish(name, *_factors(20 + rank + proj, rank))
    tables = np.zeros((4, 2), np.int32)
    scales = np.zeros(4, np.float32)
    for i, name in enumerate(("a", "b", "c")):
        h = bank.acquire(name)
        tables[i] = h.pages_padded
        scales[i] = h.scale * (i + 1)
    seq_ids = torch.from_numpy(rng.randint(0, 4, size=11).astype(np.int32))
    x = torch.from_numpy(rng.randn(11, D).astype(np.float32))
    pages_tok = torch.from_numpy(tables)[seq_ids.long()]
    scale_tok = torch.from_numpy(scales)[seq_ids.long()]
    for li in range(L):
        want = tlora.paged_lora_delta(
            x, *tlora.gather_adapter(*bank.pools(), pages_tok, li, proj),
            scale_tok)
        got = tlora.pool_lora_delta(
            x, *bank.step_pools(li, proj),
            tlora.page_mask(pages_tok, bank.num_pages), scale_tok)
        mag = float(want.abs().max())
        assert mag > 0
        assert float((got - want).abs().max()) <= POOL_REL_TOL * mag
        null = seq_ids == 3
        assert bool(null.any())
        assert torch.equal(got[null], torch.zeros_like(got[null]))


def test_lora_delta_through_the_registry_and_nd():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, D).astype(np.float32)
    a = rng.randn(D, 6).astype(np.float32)
    b = rng.randn(6, D).astype(np.float32)
    want = np.asarray(jlora.lora_delta(jnp.asarray(x), jnp.asarray(a),
                                       jnp.asarray(b), alpha=3.0))
    op = get_op("lora_delta")
    got_op = op.impl(*(torch.from_numpy(v) for v in (x, a, b)), alpha=3.0)
    got_nd = nd.lora_delta(torch.from_numpy(x), torch.from_numpy(a),
                           torch.from_numpy(b), alpha=3.0)
    for got in (got_op, got_nd):
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                                   rtol=1e-5)


# --------------------------------------------------------- the model --
def test_bank_pages_and_arrays_match_the_jax_bank(banks):
    """Same publishes, same page ids, versions, scales and factor bytes."""
    jb, tb = banks
    assert jb.names() == tb.names()
    for name in tb.names():
        ja, jbb, js = jb.adapter_arrays(name)
        ta, tbb, ts = tb.adapter_arrays(name)
        assert js == ts
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
        np.testing.assert_array_equal(np.asarray(jbb), tbb.numpy())
        assert jb._resident[name].pages == tb._resident[name].pages
    np.testing.assert_array_equal(np.asarray(jb.a_pages), tb.a_pages.numpy())
    np.testing.assert_array_equal(np.asarray(jb.b_pages), tb.b_pages.numpy())


@pytest.mark.parametrize("name", ["ada", "bob", "cal"])
def test_forward_with_lora_matches_the_jax_package(models, banks, name):
    jm, tm, npp, params = models
    jb, tb = banks
    rng = np.random.RandomState(5)
    toks = rng.randint(0, VOCAB, size=(2, 13)).astype(np.int32)
    jl, jk, jv = jm.forward(npp, jnp.asarray(toks),
                            lora=jb.adapter_arrays(name))
    tl, tk, tv = tm.forward(params, torch.from_numpy(toks),
                            lora=tb.adapter_arrays(name))
    for j, t in ((jl, tl), (jk, tk), (jv, tv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=LOGIT_TOL,
                                   rtol=0)
    base, _, _ = tm.forward(params, torch.from_numpy(toks))
    assert float((tl - base).abs().max()) > 1e-3       # the delta acts


@pytest.mark.parametrize("name", [None, "ada", "bob", "cal"])
def test_greedy_oracle_with_lora_matches_the_jax_package(models, banks,
                                                         name):
    jm, tm, npp, params = models
    jb, tb = banks
    rng = np.random.RandomState(7)
    for n in (1, 9, 20):
        prompt = rng.randint(0, VOCAB, size=n).tolist()
        want = jllm.greedy_decode_reference(
            jm, npp, prompt, 8,
            lora=None if name is None else jb.adapter_arrays(name))
        got = tllm.greedy_decode_reference(
            tm, params, prompt, 8,
            lora=None if name is None else tb.adapter_arrays(name))
        assert list(want) == got


def _flat_batch(rng, lens, S=4, MB=4):
    """A pack of rows 0..len(lens)-1 written from position 0 over
    distinct blocks; returns (tokens, positions, seq_ids, valid, tables)
    as int32 numpy arrays."""
    tables = np.zeros((S, MB), np.int32)
    tok, pos, sid = [], [], []
    for i, n in enumerate(lens):
        tables[i] = np.arange(1 + MB * i, 1 + MB * (i + 1))
        tok += rng.randint(0, VOCAB, size=n).tolist()
        pos += list(range(n))
        sid += [i] * n
    arr = [np.asarray(v, np.int32) for v in (tok, pos, sid, [1] * len(tok))]
    return (*arr, tables)


def _port_step(tm, params, batch, adapter=None, num_blocks=17, **kw):
    cache = PagedKVCache(L, 2, D // 2, BS, num_blocks, CTX, device="cpu")
    t = [torch.from_numpy(v) for v in batch]
    logits = tm.decode_flat(params, *t[:4], cache.k_pages, cache.v_pages,
                            t[4], adapter=adapter, **kw)
    return logits, cache


def test_decode_flat_with_adapters_matches_the_jax_step(models, banks):
    """A pack of four rows under 'ada', 'bob', none and 'cal': the port's
    step (pool form) against the JAX package's (gathered pages) over the
    same pools, tables and scales."""
    jm, tm, npp, params = models
    jb, tb = banks
    rng = np.random.RandomState(9)
    batch = _flat_batch(rng, (5, 9, 3, 12))
    tables = np.zeros((4, 2), np.int32)
    scales = np.zeros(4, np.float32)
    handles = []
    for i, name in enumerate(("ada", "bob", None, "cal")):
        if name is not None:
            h = tb.acquire(name)
            handles.append(h)
            tables[i] = h.pages_padded
            scales[i] = h.scale
    try:
        got, _ = _port_step(tm, params, batch, adapter=(
            tb, torch.from_numpy(tables), torch.from_numpy(scales)))
    finally:
        for h in handles:
            tb.release(h)
    jc = jllm.PagedKVCache(L, 2, D // 2, BS, 17, CTX)
    want, _, _ = jm.decode_flat(
        npp, *(jnp.asarray(v) for v in batch[:4]), jc.k_pages, jc.v_pages,
        jnp.asarray(batch[4]),
        adapter=(jb.a_pages, jb.b_pages, jnp.asarray(tables),
                 jnp.asarray(scales)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)


def test_base_rows_are_bit_for_bit_those_of_a_bankless_step(models, banks):
    """The null page and scale 0 give an exactly-zero delta: a base row
    beside adapter rows has the bits of the same pack without a bank."""
    _, tm, _, params = models
    _, tb = banks
    rng = np.random.RandomState(13)
    batch = _flat_batch(rng, (6, 4, 10))
    h = tb.acquire("bob")
    try:
        tables = np.zeros((4, 2), np.int32)
        tables[1] = h.pages_padded
        scales = np.array([0, h.scale, 0, 0], np.float32)
        with_bank, c1 = _port_step(tm, params, batch, adapter=(
            tb, torch.from_numpy(tables), torch.from_numpy(scales)))
    finally:
        tb.release(h)
    without, c0 = _port_step(tm, params, batch)
    for sl in (slice(0, 6), slice(10, 20)):
        assert torch.equal(with_bank[sl], without[sl])
    assert not torch.equal(with_bank[6:10], without[6:10])
    assert torch.equal(c1.k_pages[:, 1:5], c0.k_pages[:, 1:5])


@pytest.mark.parametrize("adapter", [None, "ada"])
def test_a_rows_bits_are_the_same_alone_and_packed(models, banks, adapter):
    """``decode_flat`` on the draft's route (``dense_rows=DENSE_ROWS``):
    a row's logits and the KV it writes have the same bits packed alone
    and beside rows of other lengths (and adapters)."""
    _, tm, _, params = models
    _, tb = banks
    rng = np.random.RandomState(17)
    row = _flat_batch(rng, (7,))
    beside = _flat_batch(np.random.RandomState(17), (7, 3, 12, 1))
    handles = [tb.acquire(n) for n in ("ada", "bob", "cal")]
    try:
        tables = np.zeros((4, 2), np.int32)
        scales = np.zeros(4, np.float32)
        if adapter is not None:
            tables[0] = handles[0].pages_padded
            scales[0] = handles[0].scale
        tables[1:] = [h.pages_padded for h in handles]
        scales[1:] = [h.scale for h in handles]
        ad = (tb, torch.from_numpy(tables), torch.from_numpy(scales))
        rows = tllm.model.DENSE_ROWS
        alone, ca = _port_step(tm, params, row, adapter=ad,
                               dense_rows=rows)
        packed, cp = _port_step(tm, params, beside, adapter=ad,
                                dense_rows=rows)
    finally:
        for h in handles:
            tb.release(h)
    assert torch.equal(alone, packed[:7])
    assert torch.equal(ca.k_pages[:, 1:5], cp.k_pages[:, 1:5])
    assert torch.equal(ca.v_pages[:, 1:5], cp.v_pages[:, 1:5])


@pytest.mark.parametrize("bad", ["nan_a", "inf_b", "inf_alpha"])
def test_publish_refuses_factors_that_are_not_finite(bad):
    """A NaN or an infinity in A or B, or an infinite alpha, raises
    ``AdapterError`` and leaves the bank's pages, pools and stats as
    they were (the step's delta reads every pool page for every row)."""
    bank = AdapterBank(L, D, max_adapters=2, page_rank=4, device="cpu")
    bank.publish("ada", *_factors(1, 4))
    stats = bank.stats()
    pools = [p.clone() for p in bank.pools()]
    a, b = _factors(2, 8)
    alpha = None
    if bad == "nan_a":
        a[1, 2, 3, 5] = np.nan
    elif bad == "inf_b":
        b[0, 3, 7, 1] = -np.inf
    else:
        alpha = float("inf")
    with pytest.raises(AdapterError, match="finite"):
        bank.publish("bad", a, b, alpha=alpha)
    assert bank.stats() == stats and bank.names() == ["ada"]
    assert all(torch.equal(p, q) for p, q in zip(pools, bank.pools()))
    assert bank.check()


def test_a_huge_cold_adapter_leaves_every_other_row_as_it_was(models):
    """A resident, cold adapter whose ``x @ A`` overflows to infinities
    and NaNs (finite factors of +-3e38): the step keeps each row's own
    pages' columns by a select, so the base row and the other adapters'
    rows get the logits and KV they get from a bank without it."""
    _, tm, _, params = models
    banks = []
    for huge in (False, True):
        bk = AdapterBank(L, D, max_adapters=4, page_rank=4, device="cpu")
        bk.publish("ada", *_factors(1, 4))
        bk.publish("bob", *_factors(2, 8), alpha=4.0)
        if huge:
            bk.publish("big", *_huge_factors(5, 8))
            bk.release(bk.acquire("big"))               # used, now cold
        banks.append(bk)
    a_pool, _ = banks[1].step_pools(0, tlora.PROJ_Q)
    x = torch.ones(1, D)
    assert not bool(torch.isfinite(x @ a_pool.reshape(D, -1)).all())
    batch = _flat_batch(np.random.RandomState(19), (6, 4, 10))
    runs = []
    for bk in banks:
        hs = [bk.acquire("ada"), bk.acquire("bob")]
        tables = np.zeros((4, 2), np.int32)
        scales = np.zeros(4, np.float32)
        for i, h in enumerate(hs, start=1):
            tables[i], scales[i] = h.pages_padded, h.scale
        try:
            runs.append(_port_step(tm, params, batch, adapter=(
                bk, torch.from_numpy(tables), torch.from_numpy(scales))))
        finally:
            for h in hs:
                bk.release(h)
    (la, ca), (lb, cb) = runs
    assert bool(torch.isfinite(la).all())
    assert torch.equal(la, lb)
    assert torch.equal(ca.k_pages, cb.k_pages)
    assert torch.equal(ca.v_pages, cb.v_pages)


# ------------------------------------------ the reference's signature --
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("form", ["bank", "views", "arrays"])
def test_decode_flat_takes_the_reference_positional_order(models, banks,
                                                          form, quant):
    """Both packages' ``decode_flat`` called positionally in the
    reference's order (``k_scales, v_scales, adapter, axis_name,
    w_scales``), int8 KV and int8 weights or none, with the adapter as the
    bank form ``(bank, a_tables, a_scales)`` or the reference's 4-tuple
    ``(a_pages, b_pages, a_tables, a_scales)`` (the bank's views of its
    storage, or the pools as plain arrays): the same logits within
    ``LOGIT_TOL``, and the same bits for each form."""
    jm, tm, npp, params = models
    jb, tb = banks
    rng = np.random.RandomState(21)
    batch = _flat_batch(rng, (7, 4, 11, 2))
    tables = np.zeros((4, 2), np.int32)
    scales = np.zeros(4, np.float32)
    handles = []
    for i, name in enumerate(("bob", "ada", "cal", None)):
        if name is not None:
            h = tb.acquire(name)
            handles.append(h)
            tables[i] = h.pages_padded
            scales[i] = h.scale
    t_tab, t_sc = torch.from_numpy(tables), torch.from_numpy(scales)
    adapter = {"bank": (tb, t_tab, t_sc),
               "views": (tb.a_pages, tb.b_pages, t_tab, t_sc),
               "arrays": (tb.a_pages.contiguous(), tb.b_pages.contiguous(),
                          t_tab, t_sc)}[form]
    if quant:
        jqw = jllm.quantize_weights(npp, dtype="int8")
        tqw = params_from_numpy(jqw, "cpu")
        jparams, jws, tparams, tws = jqw.params, jqw.scales, tqw.params, \
            tqw.scales
    else:
        jparams, jws, tparams, tws = npp, None, params, None
    t = [torch.from_numpy(v) for v in batch]
    caches = [PagedKVCache(L, 2, D // 2, BS, 17, CTX, device="cpu",
                           dtype="int8" if quant else "float32")
              for _ in range(2)]
    cache, ref_cache = caches
    scale_kw = ({"k_scales": ref_cache.k_scales,
                 "v_scales": ref_cache.v_scales} if quant else {})
    try:
        got = tm.decode_flat(
            tparams, *t[:4], cache.k_pages, cache.v_pages, t[4],
            cache.k_scales if quant else None,
            cache.v_scales if quant else None, adapter, None, tws)
        ref = tm.decode_flat(
            tparams, *t[:4], ref_cache.k_pages, ref_cache.v_pages, t[4],
            adapter=(tb, t_tab, t_sc), w_scales=tws, **scale_kw)
    finally:
        for h in handles:
            tb.release(h)
    shape = (L, 17, BS, 2, D // 2)
    jks = jnp.ones(shape[:-1], jnp.float32) if quant else None
    jc = jnp.zeros(shape, jnp.int8 if quant else jnp.float32)
    want = jm.decode_flat(
        jparams, *(jnp.asarray(v) for v in batch[:4]), jc, jc,
        jnp.asarray(batch[4]), jks, jks,
        (jb.a_pages, jb.b_pages, jnp.asarray(tables), jnp.asarray(scales)),
        None, jws)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)
    assert torch.equal(got, ref)
    with pytest.raises(NotImplementedError, match="axis_name"):
        tm.decode_flat(tparams, *t[:4], cache.k_pages, cache.v_pages, t[4],
                       None, None, None, "tp")

"""PyTorch port: ``LLMEngine`` in the reference's signature. The JAX
package's ``LLMEngine(model, params, max_seqs, block_size, num_blocks,
max_context, prefill_chunk, draft_model, draft_params, spec_k, stats,
dtype="float32", ...)`` takes ``dtype`` (the KV pools' float type and
the fallback of ``kv_dtype``); the port takes the same positional order,
with its own ``device`` last. ``dtype="float32"``, passed by position or
by keyword (also through ``LLMServer``), serves the JAX engine's greedy
streams token for token (the argmax is exact at these widths), and so
does ``dtype="bfloat16"`` (or ``torch.bfloat16``) the JAX engine's bf16
streams, over bf16 pools (tests/test_torch_kv16.py holds f16 and the
pools themselves).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

from mxnet_tpu.serving import llm as jllm  # noqa: E402
from mxnet_tpu_torch.serving import llm as tllm  # noqa: E402

torch.set_num_threads(2)

CFG = dict(vocab_size=48, d_model=32, num_layers=2, num_heads=2,
           d_ff=64, max_context=64)
BS, NEW = 8, 12


@pytest.fixture(scope="module")
def setup():
    """(port model, numpy params, prompts, the JAX engine's streams)."""
    jm = jllm.TinyDecoder(jllm.DecoderConfig(**CFG))
    tm = tllm.TinyDecoder(tllm.DecoderConfig(**CFG), device="cpu")
    npp = jm.init_params(seed=0)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, CFG["vocab_size"], size=n).tolist()
               for n in (3, 9, 17)]
    # the reference's positional order up to dtype
    eng = jllm.LLMEngine(jm, npp, 4, BS, None, None, 8, None, None, None,
                         None, "float32")
    bf16 = jllm.LLMEngine(jm, npp, 4, BS, None, None, 8, None, None, None,
                          None, "bfloat16")
    return (tm, npp, prompts, _drain(eng, jllm.Sequence, prompts),
            _drain(bf16, jllm.Sequence, prompts))


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


def test_positional_dtype_serves_the_jax_engines_streams(setup):
    tm, npp, prompts, want, _ = setup
    eng = tllm.LLMEngine(tm, npp, 4, BS, None, None, 8, None, None, None,
                         None, "float32", device="cpu")
    assert eng.cache.dtype_name == "float32"
    assert _drain(eng, tllm.Sequence, prompts) == want


def test_keyword_dtype_serves_the_jax_engines_streams(setup):
    tm, npp, prompts, want, _ = setup
    eng = tllm.LLMEngine(tm, npp, max_seqs=4, block_size=BS,
                         prefill_chunk=8, dtype="float32", device="cpu")
    assert _drain(eng, tllm.Sequence, prompts) == want


def test_server_passes_dtype_through(setup):
    tm, npp, prompts, want, _ = setup
    srv = tllm.LLMServer(tm, npp, max_seqs=4, block_size=BS,
                         prefill_chunk=8, dtype="float32", device="cpu")
    srv.start()
    try:
        futs = [srv.submit(p, NEW) for p in prompts]
        got = [f.result(timeout=120).tokens for f in futs]
    finally:
        srv.shutdown()
    assert got == want


@pytest.mark.parametrize("dtype", ["bfloat16", torch.bfloat16])
def test_bf16_pools_raise(setup, dtype):
    """bf16 pools serve the JAX engine's bf16 streams, which differ from
    the f32 ones (the name is kept from when bf16 pools raised)."""
    tm, npp, prompts, f32, want = setup
    eng = tllm.LLMEngine(tm, npp, 4, BS, None, None, 8, None, None, None,
                         None, dtype, device="cpu")
    assert eng.cache.k_pages.dtype == torch.bfloat16
    assert eng.cache.dtype_name == "bfloat16"
    got = _drain(eng, tllm.Sequence, prompts)
    assert got == want
    assert got != f32

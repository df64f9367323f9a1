"""PyTorch port, the engine's zero-recompile contract: the reference's
traffic of ``tests/test_llm_serving.py``
(``test_zero_recompiles_mixed_prefill_decode_staggered``: seed 4, 9
prompts, one injected every third step, after ``warmup()``) through the
port's ``LLMEngine`` and the JAX package's, on the CPU. A compile is a
kernel build or a CUDA graph capture in the port
(``telemetry.compile_count``), an XLA compile in the reference
(``CompileCounter``). Greedy streams are held token for token.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

from mxnet_tpu import serving as jserving  # noqa: E402
from mxnet_tpu.serving import llm as jllm  # noqa: E402
from mxnet_tpu_torch.serving import llm as tllm  # noqa: E402
from mxnet_tpu_torch.serving.telemetry import compile_count  # noqa: E402

torch.set_num_threads(2)


def test_reference_zero_recompile_traffic():
    """The reference's zero-recompile traffic (seed 4, 9 prompts, one
    injected every third step, after ``warmup()``) through the port's
    engine and the JAX engine: nothing compiles after warmup on either,
    every sequence finishes, and the streams are equal."""
    cfg = dict(vocab_size=17, d_model=16, num_layers=2, num_heads=2,
               d_ff=32, max_context=64)
    jm = jllm.TinyDecoder(jllm.DecoderConfig(**cfg))
    tm = tllm.TinyDecoder(tllm.DecoderConfig(**cfg), device="cpu")
    npp = jm.init_params(seed=0)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 17, size=int(rng.randint(1, 25))).tolist()
               for _ in range(9)]
    new = [int(rng.randint(1, 10)) for _ in range(9)]

    def drive(eng, seq_cls, counter):
        eng.warmup()
        live = []
        with counter() as c:
            for p, n in zip(prompts[:3], new[:3]):
                live.append(seq_cls(p, n))
                eng.add(live[-1])
            injected, steps = 3, 0
            while eng.has_work() or injected < len(prompts):
                if steps % 3 == 0 and injected < len(prompts):
                    live.append(seq_cls(prompts[injected], new[injected]))
                    eng.add(live[-1])
                    injected += 1
                eng.step()
                steps += 1
                assert steps < 1000
        assert c.count == 0
        assert all(s.state == "finished" for s in live)
        return [s.output_tokens() for s in live]

    class PortCounter:
        def __enter__(self):
            self._start, self.count = compile_count(), 0
            return self

        def __exit__(self, *exc):
            self.count = compile_count() - self._start
            return False
    port = tllm.LLMEngine(tm, npp, max_seqs=4, block_size=8,
                          max_context=64, device="cpu")
    ref = jllm.LLMEngine(jm, npp, max_seqs=4, block_size=8, max_context=64)
    mine = drive(port, tllm.Sequence, PortCounter)
    assert port.programs()["step_variants"] == \
        2 * len(port._t_buckets) * len(port._mb_widths)
    assert mine == drive(ref, jllm.Sequence, jserving.CompileCounter)

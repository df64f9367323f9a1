"""PyTorch port, the LoRA fine-tune -> publish loop
(``mxnet_tpu_torch/serving/adapters/training.py``): ``LoRAFineTuneJob``
on a two-layer decoder against the JAX package's job, and
``AdapterFineTunePublisher`` into both packages' banks.

Both jobs start from the same base weights (the JAX decoder's numpy
parameters) and the same seed, so their factors start equal and every
synthetic batch is the same numpy draw; the port's job trains through
``Trainer.compile_step`` (on the CPU its step function runs eagerly; on
the card, one graph replay a step: ``chip_smoke.py`` phase 8e). Losses
and factors agree to ``RTOL`` (the same f32 SGD arithmetic, sums in
another order).
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

from mxnet_tpu.serving import llm as jllm  # noqa: E402
from mxnet_tpu.serving.adapters import AdapterBank as JBank  # noqa: E402
from mxnet_tpu.serving.adapters import (  # noqa: E402
    AdapterFineTunePublisher as JPublisher, LoRAFineTuneJob as JJob)
from mxnet_tpu_torch.serving import llm as tllm  # noqa: E402
from mxnet_tpu_torch.serving.adapters import (  # noqa: E402
    AdapterBank, AdapterFineTunePublisher, LoRAFineTuneJob)

torch.set_num_threads(2)

L, D = 2, 16
CFG = dict(vocab_size=17, d_model=D, num_layers=L, num_heads=2, d_ff=32,
           max_context=32)
RTOL, ATOL = 1e-5, 1e-6


def _jobs():
    jm = jllm.TinyDecoder(jllm.DecoderConfig(**CFG))
    tm = tllm.TinyDecoder(tllm.DecoderConfig(**CFG), device="cpu")
    npp = jm.init_params(seed=0)
    jjob = JJob(jm, npp, "ada", rank=4, seed=3)
    tjob = LoRAFineTuneJob(tm, npp, "ada", rank=4, seed=3)
    return jjob, tjob


def test_finetune_job_matches_jax():
    """Four compiled steps: the same losses and factors as the JAX job;
    only the factors train (the base is frozen and unchanged); one
    program for the one batch size, no fallback."""
    jjob, tjob = _jobs()
    ja, jb = jjob.get_ab()
    ta, tb = tjob.get_ab()
    assert (ja == ta).all() and (jb == tb).all()
    base0 = tjob._frozen[1]["wv"].data().detach().clone()
    losses = [(jjob.step(batch_size=4), tjob.step(batch_size=4))
              for _ in range(4)]
    for s, (lj, lt) in enumerate(losses):
        np.testing.assert_allclose(lt, lj, rtol=RTOL, err_msg=f"step {s}")
    for got, want in zip(tjob.get_ab(), jjob.get_ab()):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    step = tjob.step_fn
    assert step.last_reason is None and step.cache_size() == 1
    assert len(tjob._trainer._params) == 2 * L * 4
    assert (tjob._frozen[1]["wv"].data() == base0).all()
    assert tjob.steps == 4


def test_publisher_rounds_into_both_banks():
    """Two rounds of (2 steps -> publish) into each package's bank: the
    same version numbers, and the installed pages hold what each job
    trained (the two agreeing to RTOL); a base weight changed in place
    is read by the next compiled step."""
    jjob, tjob = _jobs()
    jbank = JBank(L, D, max_adapters=2, page_rank=4)
    tbank = AdapterBank(L, D, max_adapters=2, page_rank=4, device="cpu")
    jpub = JPublisher.from_job(jbank, jjob, steps_per_publish=2)
    tpub = AdapterFineTunePublisher.from_job(tbank, tjob,
                                             steps_per_publish=2)
    for _ in range(2):
        assert tpub.run_once() == jpub.run_once()
    assert tpub.step == jpub.step == 4
    ta, tb, tscale = tbank.adapter_arrays("ada")
    ja, jb, jscale = jbank.adapter_arrays("ada")
    assert tscale == jscale
    np.testing.assert_allclose(np.asarray(ta.cpu()), np.asarray(ja),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.asarray(tb.cpu()), np.asarray(jb),
                               rtol=RTOL, atol=ATOL)
    a_now, _ = tjob.get_ab()
    np.testing.assert_allclose(np.asarray(ta.cpu())[0, :, :, :, :4],
                               a_now, rtol=0, atol=0)
    # a base refresh in place: the next step's loss is the eager loss
    # over the refreshed base, not the old base's
    from mxnet_tpu_torch import autograd as tag
    for row in tjob._frozen:
        for p in row.values():
            p.set_data(p.data().detach() * 0.5)
    x, y = tjob.make_batch(4, np.random.RandomState(5))
    with tag.pause():
        want = float(tjob._loss(x, y).mean())
    got = tjob.step(batch_size=4, rng=np.random.RandomState(5))
    assert got == want
    assert tjob.step_fn.cache_size() == 1

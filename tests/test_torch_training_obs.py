"""PyTorch port, the training series and span of ``gluon.Trainer.step``
and ``Trainer.compile_step`` (``mxnet_tpu_torch/gluon/trainer.py``,
``mxnet_tpu_torch/jit.py``) against the JAX package's.

The loop is the reference's ``tests/test_observability.py``
``_train_two_steps``: a ``Dense(4)``, SGD at lr 0.1, two batches of 8.
Each package runs it against a fresh ``MetricsRegistry`` and a fresh,
enabled tracer; the deltas of every ``mxtpu_training_*`` and
``mxtpu_trainer_update_*`` series must be equal (counts exactly; the
step-time histograms by their sample counts, since the clock differs),
the spans of the eager loop must carry the same names, and the opt-in
grad-norm gauge must agree to 1e-5 relative on the same weights.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.autograd as jag  # noqa: E402
from mxnet_tpu import gluon as jgluon, nd as jnd  # noqa: E402
from mxnet_tpu.observability import registry as jreg  # noqa: E402
from mxnet_tpu.observability import tracing as jtr  # noqa: E402
from mxnet_tpu_torch import autograd as tag  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon, nd as tnd  # noqa: E402
from mxnet_tpu_torch.convert import load_gluon_params  # noqa: E402
from mxnet_tpu_torch.observability import registry as treg  # noqa: E402
from mxnet_tpu_torch.observability import tracing as ttr  # noqa: E402

torch.set_num_threads(2)

SERIES = ("mxtpu_training_", "mxtpu_trainer_update_")


def _batches():
    rs = np.random.RandomState(3)
    return [(rs.randn(8, 3).astype(np.float32),
             rs.randn(8, 4).astype(np.float32)) for _ in range(2)]


def _jnet():
    jmx.random.seed(11)
    net = jgluon.nn.Dense(4, prefix="obs_")
    net.initialize()
    with jag.pause(train_mode=False):
        net(jnd.array(np.zeros((1, 3), np.float32)))
    return net


def _tnet(jnet):
    net = tgluon.nn.Dense(4, prefix="obs_")
    net.initialize(device="cpu")
    with tag.pause(train_mode=False):
        net(torch.zeros(1, 3))
    load_gluon_params(net, {k: p.data().asnumpy() for k, p in
                            jnet.collect_params().items()})
    return net


def _j_loop(compiled):
    net = _jnet()
    tr = jgluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    loss_fn = jgluon.loss.L2Loss()
    step = tr.compile_step(lambda x, y: loss_fn(net(x), y)) \
        if compiled else None
    for x, y in _batches():
        x, y = jnd.array(x), jnd.array(y)
        if step is not None:
            step(x, y)
            continue
        with jag.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(8)


def _t_loop(compiled):
    net = _tnet(_jnet())
    tr = tgluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    loss_fn = tgluon.loss.L2Loss()
    step = tr.compile_step(lambda x, y: loss_fn(net(x), y)) \
        if compiled else None
    for x, y in _batches():
        x, y = tnd.array(x, ctx="cpu"), tnd.array(y, ctx="cpu")
        if step is not None:
            step(x, y)
            continue
        with tag.record():
            loss = loss_fn(net(x), y)
        tag.backward(loss)
        tr.step(8)


def _series(reg):
    """``{(name, labels): value}`` of the training series: a counter's or
    gauge's value, a histogram's sample count."""
    out = {}
    for m in reg.metrics():
        if not m.name.startswith(SERIES):
            continue
        for child in m.children():
            labels = tuple(sorted(child.labels_dict.items()))
            v = child.count if hasattr(child, "count") else child.value
            out[(m.name, labels)] = v
    return out


def _run(reg_mod, tr_mod, loop, compiled, monkeypatch):
    reg = reg_mod.MetricsRegistry()
    tracer = tr_mod.Tracer(registry=reg).enable()
    monkeypatch.setattr(reg_mod, "_global", reg)
    monkeypatch.setattr(tr_mod, "_global", tracer)
    loop(compiled)
    return _series(reg), [s["name"] for s in tracer.snapshot()]


@pytest.mark.parametrize("compiled", [False, True],
                         ids=["eager", "compiled"])
def test_training_series_and_spans_match_the_reference(compiled,
                                                       monkeypatch):
    monkeypatch.delenv("MXNET_TPU_METRICS_GRAD_NORM", raising=False)
    jser, jspans = _run(jreg, jtr, _j_loop, compiled, monkeypatch)
    tser, tspans = _run(treg, ttr, _t_loop, compiled, monkeypatch)
    assert tser == jser
    steps = ("mxtpu_training_optimizer_steps_total", ())
    examples = ("mxtpu_training_examples_total", ())
    assert tser[steps] == 2 and tser[examples] == 16
    assert tser[("mxtpu_training_optimizer_step_seconds", ())] == 2
    if not compiled:
        assert tspans == jspans
        assert tspans.count("mxtpu.trainer.step") == 2
        assert tser[("mxtpu_trainer_update_fused_total", ())] == 2
    else:
        assert tspans.count("mxtpu.train_step") == 2


def test_grad_norm_gauge_opt_in_matches_the_reference(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_METRICS_GRAD_NORM", "1")
    jser, _ = _run(jreg, jtr, _j_loop, False, monkeypatch)
    tser, _ = _run(treg, ttr, _t_loop, False, monkeypatch)
    key = ("mxtpu_training_grad_norm", ())
    assert tser[key] > 0
    np.testing.assert_allclose(tser[key], jser[key], rtol=1e-5)
    # the fold-reduce is off under the gauge: the same update counts
    drop = {key}
    assert {k: v for k, v in tser.items() if k not in drop} == \
        {k: v for k, v in jser.items() if k not in drop}


def test_update_fallback_counted_by_reason(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FUSED_UPDATE", "0")
    monkeypatch.delenv("MXNET_TPU_METRICS_GRAD_NORM", raising=False)
    jser, _ = _run(jreg, jtr, _j_loop, False, monkeypatch)
    tser, _ = _run(treg, ttr, _t_loop, False, monkeypatch)
    fb = [k for k in tser if k[0] == "mxtpu_trainer_update_fallback_total"]
    assert fb and tser[fb[0]] == 2
    assert tser == jser

"""PyTorch port, ``mx.callback`` and ``mx.monitor``
(``mxnet_tpu_torch/{callback,monitor}.py``) against the JAX package's.

- ``Speedometer`` logs the same metric names and values at the same
  batches (the speed is a clock and is not compared); ``ProgressBar``,
  ``log_train_metric`` and ``LogValidationMetricsCallback`` log the same
  lines; ``module_checkpoint`` calls ``save_checkpoint`` at the same
  epochs; ``do_checkpoint`` writes the same checkpoint files at the
  same epochs, the port's loading in the JAX package bit for bit;
- ``Monitor`` on the toy net of ``tests/test_estimator.py`` (the JAX
  net's weights carried into the port's): the same ``(step, name)`` rows
  for the same ``interval``/``pattern``/``sort``, stats equal to 1e-6
  relative, under the default ``|x|/size`` stat and a custom one.
"""
import logging
import os
import re
import sys
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
import mxnet_tpu.autograd as jag  # noqa: E402
from mxnet_tpu import callback as jcb, metric as jm  # noqa: E402
from mxnet_tpu import gluon as jgluon, monitor as jmon  # noqa: E402
from mxnet_tpu import nd as jnd  # noqa: E402
from mxnet_tpu_torch import autograd as tag  # noqa: E402
from mxnet_tpu_torch import callback as tcb, metric as tm  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon, monitor as tmon  # noqa: E402
from mxnet_tpu_torch.convert import load_gluon_params  # noqa: E402

torch.set_num_threads(2)

RS = np.random.RandomState(9)
LABELS = [RS.randint(3, size=4).astype(np.float32) for _ in range(7)]
PREDS = [RS.uniform(size=(4, 3)).astype(np.float32) for _ in range(7)]


def _logged(caplog, pkg, cb_of, metric_of, epochs=(0,)):
    """Drive a batch-end callback over 7 batches an epoch, updating an
    Accuracy metric of the package first; the log lines it wrote."""
    mod_m, arr = (jm, jnd.array) if pkg == "jax" else (tm, torch.from_numpy)
    cb = cb_of(pkg)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        for epoch in epochs:
            metric = metric_of(mod_m)
            for nbatch in range(7):
                metric.update([arr(LABELS[nbatch])], [arr(PREDS[nbatch])])
                cb(SimpleNamespace(epoch=epoch, nbatch=nbatch,
                                   eval_metric=metric, locals=None))
    return [r.getMessage() for r in caplog.records]


def _no_speed(line):
    return re.sub(r"Speed: [0-9.inf]+ samples/sec", "Speed: -", line)


CALLBACKS = {
    "speedometer": lambda pkg: (jcb if pkg == "jax" else tcb).Speedometer(
        batch_size=4, frequent=2),
    "speedometer_no_reset": lambda pkg: (
        jcb if pkg == "jax" else tcb).Speedometer(4, 3, auto_reset=False),
    "progress_bar": lambda pkg: (jcb if pkg == "jax" else tcb).ProgressBar(
        total=7, length=20),
    "log_train_metric": lambda pkg: (
        jcb if pkg == "jax" else tcb).log_train_metric(2, auto_reset=True),
    "log_validation": lambda pkg: (
        jcb if pkg == "jax" else tcb).LogValidationMetricsCallback(),
}


@pytest.mark.parametrize("name", sorted(CALLBACKS))
def test_callback_logs_match_the_reference(name, caplog):
    metric_of = (lambda m: m.CompositeEvalMetric(
        [m.Accuracy(), m.TopKAccuracy(2)]))
    lines = {pkg: _logged(caplog, pkg, CALLBACKS[name], metric_of,
                          epochs=(0, 1))
             for pkg in ("jax", "torch")}
    assert lines["torch"], name
    assert [_no_speed(s) for s in lines["torch"]] == \
        [_no_speed(s) for s in lines["jax"]]
    if name == "speedometer":
        assert "Batch [0-2]" in lines["torch"][0]
        assert "accuracy=" in lines["torch"][0]
        assert "top_k_accuracy_2=" in lines["torch"][0]


def test_module_checkpoint_and_do_checkpoint(tmp_path):
    calls = {}
    for pkg, cb in (("jax", jcb), ("torch", tcb)):
        seen = calls[pkg] = []
        mod = SimpleNamespace(save_checkpoint=lambda *a: seen.append(a))
        fn = cb.module_checkpoint(mod, "pfx", period=2,
                                  save_optimizer_states=True)
        for i in range(5):
            fn(i)
    assert calls["torch"] == calls["jax"] == [("pfx", 2, True),
                                              ("pfx", 4, True)]
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    for pkg, cb, mx in (("jax", jcb, jmx), ("torch", tcb, tmx)):
        sym = mx.sym.var("w")
        arg = {"w": jnd.array(w) if pkg == "jax" else torch.from_numpy(w)}
        fn = cb.do_checkpoint(str(tmp_path / pkg), period=2)
        for i in range(5):
            fn(i, sym, arg, {})
    for pkg in ("jax", "torch"):
        assert sorted(p.name for p in tmp_path.glob(f"{pkg}-*")) == [
            f"{pkg}-0002.params", f"{pkg}-0004.params", f"{pkg}-symbol.json"]
    got = jnd.load(str(tmp_path / "torch-0004.params"))
    want = jnd.load(str(tmp_path / "jax-0004.params"))
    assert sorted(got) == sorted(want) == ["arg:w"]
    assert np.array_equal(got["arg:w"].asnumpy(), want["arg:w"].asnumpy())


def _nets():
    jmx.random.seed(0)
    jnet = jgluon.nn.HybridSequential(prefix="mon_")
    with jnet.name_scope():
        jnet.add(jgluon.nn.Dense(16, activation="relu"), jgluon.nn.Dense(2))
    jnet.initialize()
    with jag.pause(train_mode=False):
        jnet(jnd.array(np.zeros((1, 8), np.float32)))
    tnet = tgluon.nn.HybridSequential(prefix="mon_")
    with tnet.name_scope():
        tnet.add(tgluon.nn.Dense(16, activation="relu"),
                 tgluon.nn.Dense(2))
    tnet.initialize(device="cpu")
    with tag.pause(train_mode=False):
        tnet(torch.zeros(1, 8))
    load_gluon_params(tnet, {k: p.data().asnumpy() for k, p in
                             jnet.collect_params().items()})
    return jnet, tnet


NETS = _nets()
X = [np.random.RandomState(s).randn(4, 8).astype(np.float32)
     for s in range(4)]


def _rows(pkg, **kw):
    net = NETS[0] if pkg == "jax" else NETS[1]
    mon = (jmon if pkg == "jax" else tmon).Monitor(**kw).install(net)
    rows = []
    for x in X:
        mon.tic()
        with (jag if pkg == "jax" else tag).pause():
            net(jnd.array(x) if pkg == "jax" else torch.from_numpy(x))
        rows.extend(mon.toc())
    for h in mon._handles:
        h.detach()
    return rows


@pytest.mark.parametrize("kw", [
    {},
    {"interval": 2, "sort": True},
    {"pattern": r".*dense1.*"},
    {"stat_func": lambda a: float(np.max(np.abs(a)))},
], ids=["default", "interval_sorted", "pattern", "custom_stat"])
def test_monitor_rows_match_the_reference(kw):
    j, t = _rows("jax", **kw), _rows("torch", **kw)
    assert [(s, n) for s, n, _ in t] == [(s, n) for s, n, _ in j]
    assert t, "no rows"
    np.testing.assert_allclose([v for _, _, v in t], [v for _, _, v in j],
                               rtol=1e-6)

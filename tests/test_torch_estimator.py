"""PyTorch port, ``gluon.contrib.estimator`` (``mxnet_tpu_torch/gluon/
contrib/estimator/``) against the JAX package's, on the toy problem of
``tests/test_estimator.py``: a linearly separable 2-class problem, a
``Dense(16, relu) -> Dense(2)`` net, SGD with momentum 0.9 at lr 0.1.

Both packages start from the same weights (the JAX net's, carried into
the port's by ``convert.load_gluon_params``) and take the same numpy
batches. Held equal:

- the sequence of handler events (train/epoch/batch begin and end);
- per-epoch train loss and accuracy, to 1e-5 relative (the same f32
  arithmetic, XLA reassociating its sums), and the validation metrics;
- the checkpoint rotation's file names (``CheckpointHandler``, keep 2);
- ``stopped_epoch`` of the lr=0 early stop;
- ``fit(batches=3)`` stops after 3 batches.

And in the port alone: ``fit(compiled_step=True)`` gives the weights of
the eager ``fit`` bit for bit (on the CPU the compiled step runs its step
function eagerly), with one ``CompiledTrainStep`` per estimator.
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
from mxnet_tpu.gluon.contrib import estimator as jest  # noqa: E402
from mxnet_tpu_torch import autograd as tag  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch.convert import load_gluon_params  # noqa: E402
from mxnet_tpu_torch.gluon.contrib import estimator as test_  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-5
EPOCHS = 3


def _toy_data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32)
    return x, y


def _batches(x, y, batch=16):
    return [(x[i:i + batch], y[i:i + batch])
            for i in range(0, len(x), batch)]


def _jnet(seed=0):
    jmx.random.seed(seed)
    net = jgluon.nn.HybridSequential(prefix="est_")
    with net.name_scope():
        net.add(jgluon.nn.Dense(16, activation="relu"), jgluon.nn.Dense(2))
    net.initialize()
    with jag.pause(train_mode=False):
        net(jnd.array(np.zeros((1, 8), np.float32)))
    return net


def _tnet(jnet):
    net = tgluon.nn.HybridSequential(prefix="est_")
    with net.name_scope():
        net.add(tgluon.nn.Dense(16, activation="relu"), tgluon.nn.Dense(2))
    net.initialize(device="cpu")
    with tag.pause(train_mode=False):
        net(torch.zeros(1, 8))
    load_gluon_params(net, {k: p.data().asnumpy() for k, p in
                            jnet.collect_params().items()})
    return net


def _make(pkg, lr=0.1):
    gl, est_mod = (jgluon, jest) if pkg == "jax" else (tgluon, test_)
    jnet = _jnet()
    net = jnet if pkg == "jax" else _tnet(jnet)
    est = est_mod.Estimator(
        net, gl.loss.SoftmaxCrossEntropyLoss(),
        trainer=gl.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": lr, "momentum": 0.9}))
    return est, est_mod


def _loader(pkg, batches):
    if pkg == "jax":
        return [(jnd.array(x), jnd.array(y)) for x, y in batches]
    return [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches]


def _recorder(est_mod, log):
    class Recorder(est_mod.TrainBegin, est_mod.TrainEnd,
                   est_mod.EpochBegin, est_mod.EpochEnd,
                   est_mod.BatchBegin, est_mod.BatchEnd):
        def train_begin(self, est, *a, **kw):
            log.append(("train_begin",))

        def train_end(self, est, *a, **kw):
            log.append(("train_end",))

        def epoch_begin(self, est, *a, **kw):
            log.append(("epoch_begin",))

        def batch_begin(self, est, *a, **kw):
            log.append(("batch_begin",))

        def batch_end(self, est, *a, **kw):
            log.append(("batch_end",))

        def epoch_end(self, est, *a, **kw):
            log.append(("epoch_end",
                        est.train_metrics[0].get(),
                        est.train_loss_metric.get(),
                        est.val_metrics[0].get(),
                        est.val_loss_metric.get()))
    return Recorder()


def _fit_run(pkg, ckpt_dir):
    x, y = _toy_data(64)
    xv, yv = _toy_data(32, seed=1)
    est, est_mod = _make(pkg)
    log = []
    ck = est_mod.CheckpointHandler(ckpt_dir, model_prefix="toy",
                                   epoch_period=1, max_checkpoints=2)
    est.fit(_loader(pkg, _batches(x, y)),
            val_data=_loader(pkg, _batches(xv, yv)), epochs=EPOCHS,
            event_handlers=[_recorder(est_mod, log), ck])
    files = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".params"))
    return log, files


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for pkg in ("jax", "torch"):
        out[pkg] = _fit_run(pkg, str(tmp_path_factory.mktemp(pkg)))
    return out


def test_event_sequences_are_identical(runs):
    names = {pkg: [e[0] for e in runs[pkg][0]] for pkg in runs}
    assert names["torch"] == names["jax"]
    assert names["torch"].count("batch_end") == 4 * EPOCHS
    assert names["torch"][0] == "train_begin"
    assert names["torch"][-1] == "train_end"


def test_per_epoch_metrics_agree(runs):
    jends = [e for e in runs["jax"][0] if e[0] == "epoch_end"]
    tends = [e for e in runs["torch"][0] if e[0] == "epoch_end"]
    assert len(tends) == len(jends) == EPOCHS
    for je, te in zip(jends, tends):
        for (jname, jval), (tname, tval) in zip(je[1:], te[1:]):
            assert tname == jname
            np.testing.assert_allclose(tval, jval, rtol=RTOL)
    # it learns: the train loss falls epoch over epoch
    losses = [te[2][1] for te in tends]
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


def test_checkpoint_rotation_keeps_the_same_files(runs):
    assert runs["torch"][1] == runs["jax"][1]
    assert runs["torch"][1] == ["toy-epoch2.params", "toy-epoch3.params"]


def test_early_stop_at_the_same_epoch():
    x, y = _toy_data(64)
    stopped = {}
    for pkg in ("jax", "torch"):
        est, est_mod = _make(pkg, lr=0.0)
        early = est_mod.EarlyStoppingHandler(
            monitor=est.train_loss_metric, patience=1)
        est.fit(_loader(pkg, _batches(x, y)), epochs=50,
                event_handlers=[early])
        stopped[pkg] = early.stopped_epoch
    assert stopped["torch"] == stopped["jax"]
    assert stopped["torch"] is not None and stopped["torch"] < 10


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_fit_batches_limit(pkg):
    x, y = _toy_data(64)
    est, est_mod = _make(pkg)
    log = []
    est.fit(_loader(pkg, _batches(x, y)), batches=3,
            event_handlers=[_recorder(est_mod, log)])
    assert [e[0] for e in log].count("batch_end") == 3


def _weights(net):
    return {k: p.data().detach().clone()
            for k, p in net.collect_params().items()}


def test_compiled_step_fit_gives_the_eager_weights():
    x, y = _toy_data(64)
    out = {}
    for compiled in (False, True):
        est, _ = _make("torch")
        est.fit(_loader("torch", _batches(x, y)), epochs=2,
                compiled_step=compiled)
        if compiled:
            step = est._compiled_step_auto
            assert step is not None and step.last_reason is None
            est.fit(_loader("torch", _batches(x, y)), batches=1,
                    compiled_step=True)
            assert est._compiled_step_auto is step   # one per estimator
        else:
            est.fit(_loader("torch", _batches(x, y)), batches=1)
        out[compiled] = (_weights(est.net), est.train_metrics[0].get(),
                         est.train_loss_metric.get())
    for k, w in out[False][0].items():
        assert torch.equal(out[True][0][k], w), k
    assert out[True][1:] == out[False][1:]

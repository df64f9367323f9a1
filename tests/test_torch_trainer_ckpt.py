"""PyTorch port, the Trainer's checkpoints (``mxnet_tpu_torch/gluon/
trainer.py``): ``save_states`` through ``atomic_write``, and the full
training state through ``save_state`` / ``restore_state`` / ``ckpt_wait``
on the checkpoint stack, on the CPU.

- a ``save_states`` write killed at byte N leaves the previous states
  file loadable (the counterpart of ``tests/test_resilience.py``'s
  killed ``nd.save``);
- resume is bit-exact (weights and Adam slots) through v1 and sharded
  v2 checkpoints, sync and async, with dropout drawing from the restored
  generator, and under a loss scaler whose scale moves (the counterparts
  of ``tests/test_resilience.py::test_gluon_trainer_restore_bit_exact``
  and ``tests/test_checkpoint_sharded.py::
  test_gluon_trainer_sharded_async_bit_exact``);
- the ``param:i`` arrays of a JAX trainer's checkpoint read by the port
  equal the JAX parameters, the port restores them, and the reverse;
- the preemption drill (SIGTERM at step K, checkpoint, resume), the
  async overlap counter, a failed background save raised typed by
  ``ckpt_wait``, and the restore's typed errors.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.autograd as jag  # noqa: E402
from mxnet_tpu import nd as jnd  # noqa: E402
from mxnet_tpu import resilience as jrz  # noqa: E402
from mxnet_tpu.gluon import nn as jnn  # noqa: E402
from mxnet_tpu_torch import amp, autograd, error  # noqa: E402
from mxnet_tpu_torch import resilience as rz  # noqa: E402
from mxnet_tpu_torch.gluon import Trainer, nn  # noqa: E402
from mxnet_tpu_torch.gluon.parameter import Parameter  # noqa: E402
from mxnet_tpu_torch.observability import get_registry  # noqa: E402
from mxnet_tpu_torch.resilience import async_writer as aw  # noqa: E402
from mxnet_tpu_torch.resilience import faults  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("MXNET_TPU_CKPT_ASYNC", "MXNET_TPU_CKPT_SHARDED",
                "MXNET_TPU_CKPT_WRITERS"):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    yield
    faults.reset()
    aw._reset_for_tests()


def _net(seed):
    """Dense-ReLU-Dropout-Dense on the CPU, initialized from ``seed``."""
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=4, activation="relu"), nn.Dropout(0.3),
            nn.Dense(2, in_units=8))
    net.initialize(device="cpu",
                   generator=torch.Generator().manual_seed(seed))
    return net


def _batch():
    rs = np.random.RandomState(0)
    return (torch.from_numpy(rs.randn(8, 4).astype(np.float32)),
            torch.from_numpy(rs.randn(8, 2).astype(np.float32)))


def _train(net, trainer, n):
    x, y = _batch()
    for _ in range(n):
        with autograd.record():
            loss = ((net(x) - y) ** 2).sum()
            with amp.scale_loss(loss, trainer) as scaled:
                pass
        scaled.backward()
        trainer.step(x.shape[0])


def _state(trainer):
    """Weights and optimizer slots, bit for bit."""
    out = [p.data().detach().clone() for p in trainer._params]
    for i in sorted(trainer._updaters[0].states):
        st = trainer._updaters[0].states[i]
        out += [s.detach().clone() for s in
                (st if isinstance(st, (tuple, list)) else [st])]
    return out


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --------------------------------------------------- Part A: the fault --
def test_save_states_killed_at_any_byte_keeps_the_previous_file(tmp_path):
    net = _net(7)
    tr = Trainer(net.collect_params(), "adam", {"learning_rate": 0.05})
    _train(net, tr, 2)
    fname = str(tmp_path / "adam.states")
    tr.save_states(fname)
    good = open(fname, "rb").read()
    _train(net, tr, 1)
    newer = tr._updaters[0].get_states()
    for cut in range(0, len(newer) + 1, max(1, len(newer) // 9)):
        faults.kill_write_at("adam.states", cut)
        with pytest.raises(rz.InjectedCrash):
            tr.save_states(fname)
        faults.reset()
        assert open(fname, "rb").read() == good, cut
        tr2 = Trainer(_net(8).collect_params(), "adam",
                      {"learning_rate": 0.05})
        tr2.load_states(fname)          # the previous file still loads
        assert sorted(tr2._updaters[0].states) == \
            sorted(tr._updaters[0].states)
    tr.save_states(fname)
    assert open(fname, "rb").read() == newer


# ----------------------------------------------------------- bit exact --
@pytest.mark.parametrize("mode", ["sync", "sync_sharded", "async",
                                  "async_sharded"])
def test_trainer_resume_is_bit_exact(tmp_path, monkeypatch, mode):
    """3 steps, save, 4 more; a fresh net and Trainer restore and take the
    same 4: weights and Adam slots bit-identical (dropout draws from the
    restored generator)."""
    if mode.startswith("async"):
        monkeypatch.setenv("MXNET_TPU_CKPT_ASYNC", "1")
    shards = 3 if mode.endswith("sharded") else None
    run = str(tmp_path / "run")
    netA = _net(7)
    trA = Trainer(netA.collect_params(), "adam", {"learning_rate": 0.05})
    _train(netA, trA, 3)
    handle = trA.save_state(run, num_shards=shards)
    assert handle
    if mode.startswith("async"):
        assert isinstance(handle, rz.AsyncSaveHandle)
    trA.ckpt_wait()
    _train(netA, trA, 4)
    netB = _net(123)            # another init: the restore overwrites it
    trB = Trainer(netB.collect_params(), "adam", {"learning_rate": 0.05})
    manifest = trB.restore_state(run)
    assert manifest["step"] == 3 and trB._step_count == 3
    assert manifest["format"] == ("mxtpu-ckpt-v2" if shards
                                  else "mxtpu-ckpt-v1")
    assert manifest["extra"]["param_names"] == \
        [p.name for p in trA._params]
    _train(netB, trB, 4)
    assert trB._step_count == 7
    _assert_same(_state(trA), _state(trB))


def test_trainer_resume_under_the_loss_scaler(tmp_path):
    """A scaler whose scale moves every 2 steps: the restored run keeps
    its scale and window position and continues bit for bit."""
    def make(seed):
        net = _net(seed)
        tr = Trainer(net.collect_params(), "adam", {"learning_rate": 0.05})
        amp.init_trainer(tr, loss_scaler=amp.LossScaler(
            init_scale=2.0 ** 4, scale_window=2, target_dtype="float16"))
        return net, tr
    run = str(tmp_path / "run")
    netA, trA = make(7)
    _train(netA, trA, 3)
    trA.save_state(run, num_shards=2)
    scale = trA._amp_loss_scaler.loss_scale
    assert scale == 2.0 ** 5
    _train(netA, trA, 3)
    netB, trB = make(5)
    manifest = trB.restore_state(run)
    assert manifest["extra"]["scaler"]["loss_scale"] == scale
    assert trB._amp_loss_scaler.loss_scale == scale
    assert trB._amp_loss_scaler._unskipped == 1
    _train(netB, trB, 3)
    assert trB._amp_loss_scaler.loss_scale == \
        trA._amp_loss_scaler.loss_scale
    _assert_same(_state(trA), _state(trB))


# ----------------------------------------------- across the two packages --
def _jax_trainer(seed=7):
    mx.nd.random.seed(seed)
    net = jnn.Dense(2, in_units=4)
    net.initialize()
    tr = mx.gluon.Trainer(net.collect_params(), "adam",
                          {"learning_rate": 0.05})
    x, y = (v.numpy() for v in _batch())
    for _ in range(3):
        with jag.record():
            loss = ((net(jnd.array(x)) - jnd.array(y)) ** 2).sum()
        loss.backward()
        tr.step(8)
    return tr


@pytest.mark.parametrize("num_shards", [None, 2])
def test_jax_trainer_checkpoint_reads_into_the_port(tmp_path, num_shards):
    """The ``param:i`` arrays of the JAX Trainer's checkpoint equal its
    parameters; a port Trainer over parameters of the same shapes
    restores them (the reference's RNG entry ignored) and its step."""
    run = str(tmp_path / "run")
    jtr = _jax_trainer()
    assert jtr.save_state(run, num_shards=num_shards)
    want = [p._get_primary().asnumpy() for p in jtr._params]
    path, manifest = rz.latest_checkpoint(run)
    arrays = rz.read_arrays(path, manifest)
    assert sorted(arrays) == [f"param:{i}" for i in range(len(want))]
    for i, w in enumerate(want):
        assert np.array_equal(arrays[f"param:{i}"].numpy(), w)
    params = []
    for i, w in enumerate(want):
        p = Parameter(f"p{i}", shape=w.shape)
        p.initialize(device="cpu")
        params.append(p)
    tr = Trainer(params, "adam", {"learning_rate": 0.05})
    tr.restore_state(run)
    assert tr._step_count == 3
    for p, w in zip(params, want):
        assert np.array_equal(p.data().detach().numpy(), w)


def test_port_trainer_checkpoint_reads_into_the_jax_package(tmp_path):
    run = str(tmp_path / "run")
    net = _net(7)
    tr = Trainer(net.collect_params(), "adam", {"learning_rate": 0.05})
    _train(net, tr, 2)
    tr.save_state(run, num_shards=2)
    path, manifest = jrz.latest_checkpoint(run)
    assert manifest["step"] == 2
    arrays = jrz.read_arrays(path, manifest, verify_arrays=True)
    for i, p in enumerate(tr._params):
        assert np.array_equal(arrays[f"param:{i}"].asnumpy(),
                              p.data().detach().numpy())


# ------------------------------------------------------- the drills ----
def test_sigterm_at_step_k_checkpoint_and_resume(tmp_path):
    """SIGTERM lands at step K: the loop checkpoints at the step boundary
    and stops; a restarted Trainer restores and finishes with the
    parameters of an uninterrupted run."""
    run = str(tmp_path / "run")
    total, k = 6, 3

    def preemptible_run():
        torch.manual_seed(0)        # dropout's draws, as in run 3
        net = _net(7)
        tr = Trainer(net.collect_params(), "adam", {"learning_rate": 0.05})
        done = 0
        with rz.PreemptionGuard() as guard:
            for _ in range(total):
                _train(net, tr, 1)
                done += 1
                if guard.requested:
                    tr.save_state(run)
                    break
        return net, tr, done

    faults.sigterm_at_step(k)
    _, _, done = preemptible_run()
    faults.reset()
    assert done == k
    assert rz.latest_checkpoint(run)[1]["step"] == k
    net2 = _net(55)
    tr2 = Trainer(net2.collect_params(), "adam", {"learning_rate": 0.05})
    tr2.restore_state(run)
    _train(net2, tr2, total - k)
    torch.manual_seed(0)
    net3 = _net(7)
    tr3 = Trainer(net3.collect_params(), "adam", {"learning_rate": 0.05})
    _train(net3, tr3, total)
    _assert_same(_state(tr2), _state(tr3))


def test_async_save_off_the_critical_path_and_overlap_counted(
        tmp_path, monkeypatch):
    """The writer parks on a gate mid-save while the Trainer takes real
    steps: the overlap counter records them, the snapshot keeps the
    saved step's weights, release commits."""
    monkeypatch.setenv("MXNET_TPU_CKPT_ASYNC", "1")
    run = str(tmp_path / "run")
    net = _net(7)
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    _train(net, tr, 1)
    saved = [p.data().detach().clone() for p in tr._params]
    gate = faults.block_at("checkpoint.write")
    handle = tr.save_state(run)
    assert isinstance(handle, rz.AsyncSaveHandle) and not handle.done()
    assert gate.wait_reached()
    reg = get_registry()
    overlap = reg.counter("mxtpu_ckpt_async_overlap_steps_total")
    in_flight = reg.gauge("mxtpu_ckpt_async_in_flight")
    before = overlap.value
    assert in_flight.value == 1
    _train(net, tr, 3)
    assert overlap.value == before + 3
    gate.release()
    assert rz.validate_checkpoint(handle.result(30))["step"] == 1
    faults.reset()
    tr.ckpt_wait()
    assert in_flight.value == 0
    tr2 = Trainer(_net(9).collect_params(), "sgd", {"learning_rate": 0.1})
    tr2.restore_state(run)
    _assert_same(saved, [p.data().detach() for p in tr2._params])


def test_ckpt_wait_raises_a_failed_background_save_typed(tmp_path,
                                                        monkeypatch):
    from mxnet_tpu_torch.resilience import retry as retry_mod
    monkeypatch.setattr(retry_mod.time, "sleep", lambda s: None)
    monkeypatch.setenv("MXNET_TPU_CKPT_ASYNC", "1")
    run = str(tmp_path / "run")
    net = _net(7)
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    _train(net, tr, 1)
    faults.script("checkpoint.write", [OSError("disk gone")] * 4)
    assert tr.save_state(run)
    with pytest.raises(error.CheckpointWriteError):
        tr.ckpt_wait()
    faults.reset()
    tr.ckpt_wait()              # the error was raised once, not parked
    assert tr.save_state(run).result(30)


def test_restore_raises_typed_errors(tmp_path):
    net = _net(7)
    tr = Trainer(net.collect_params(), "adam", {"learning_rate": 0.05})
    with pytest.raises(error.CheckpointCorruptError):
        tr.restore_state(str(tmp_path / "empty"))
    # a checkpoint of other shapes
    other = [Parameter(f"q{i}", shape=(3, 3)) for i in range(4)]
    for p in other:
        p.initialize(device="cpu")
    run = str(tmp_path / "shapes")
    Trainer(other, "adam", {"learning_rate": 0.05}).save_state(run)
    with pytest.raises(error.InternalError, match="has shape"):
        tr.restore_state(run)
    # a checkpoint missing a parameter
    run = str(tmp_path / "missing")
    Trainer(list(tr._params[:2]), "adam",
            {"learning_rate": 0.05}).save_state(run)
    with pytest.raises(error.InternalError, match="missing parameter"):
        tr.restore_state(run)

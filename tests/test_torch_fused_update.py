"""PyTorch port, the fused Trainer update (``mxnet_tpu_torch/optimizer/
fused.py``): the one-device cases of ``tests/test_fused_update.py``.

The fused step must give the per-parameter loop's bits (weights, states,
update counts) for the nine fusable optimizers, across lr and batch-size
changes and under a loss scaler; an lr change builds nothing new; a step
is one dispatch (one ``multi_update`` call: on the card one kernel
launch) for 2 and for 200 parameters; every fallback reason label is
reached; states written by the fused path reload and continue on it;
and parameters whose tensors overlap in memory take the loop.

On the CPU a dispatch is one pass of the update op's twin over the
group's tensors, as the loop runs the same twin per parameter; the
kernel's launches are counted on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Everything here is held bit for bit.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

from mxnet_tpu_torch import amp, kernels  # noqa: E402
from mxnet_tpu_torch import optimizer as topt  # noqa: E402
from mxnet_tpu_torch.gluon import Trainer  # noqa: E402
from mxnet_tpu_torch.gluon.parameter import Parameter  # noqa: E402
from mxnet_tpu_torch.ops import optimizer_ops as tops  # noqa: E402

torch.set_num_threads(2)


def _make_params(n=7, seed=0, dtype="float32"):
    rng = np.random.RandomState(seed)
    params = []
    for i in range(n):
        shape = (3 + (i % 5), 4)
        p = Parameter(f"p{i}", shape=shape, dtype=dtype)
        p.initialize(device="cpu")
        p.set_data(torch.from_numpy(rng.randn(*shape).astype(np.float32)))
        params.append(p)
    return params


def _set_grads(params, seed):
    rng = np.random.RandomState(seed)
    for p in params:
        g = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
        p.grad().copy_(g)


def _run(monkeypatch, opt, opt_args, fused, steps=5, lr_seq=None,
         batch_seq=None, scaler=None, dtype="float32"):
    monkeypatch.setenv("MXNET_TPU_FUSED_UPDATE", "1" if fused else "0")
    params = _make_params(dtype=dtype)
    params[1].lr_mult = 0.5
    params[2].wd_mult = 0.0
    trainer = Trainer(params, opt, dict(opt_args))
    if scaler is not None:
        amp.init_trainer(trainer, loss_scaler=scaler())
    for s in range(steps):
        if lr_seq:
            trainer.set_learning_rate(lr_seq[s % len(lr_seq)])
        _set_grads(params, 100 + s)
        trainer.step(batch_seq[s % len(batch_seq)] if batch_seq else 32)
        if fused:
            assert trainer._fused.fallbacks == {}
            assert trainer._fused.last_dispatches == 1
    return [p.data().detach().clone() for p in params], trainer


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    return [state]


FUSED_CASES = [
    ("sgd", {"learning_rate": 0.05}, "float32"),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
             "clip_gradient": 0.4}, "float32"),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
             "multi_precision": True}, "bfloat16"),
    ("sgd", {"learning_rate": 0.05, "multi_precision": True}, "float16"),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
     "float32"),
    ("adam", {"learning_rate": 1e-3, "wd": 1e-3}, "float32"),
    ("adamw", {"learning_rate": 1e-3, "wd": 1e-2, "eta": 0.5,
               "clip_gradient": 0.4}, "float32"),
    ("adagrad", {"learning_rate": 0.05, "wd": 1e-3}, "float32"),
    ("rmsprop", {"learning_rate": 1e-3}, "float32"),
    ("rmsprop", {"learning_rate": 1e-3, "centered": True,
                 "clip_weights": 1.5}, "float32"),
    ("ftrl", {"learning_rate": 0.05, "beta": 1.0, "wd": 1e-3}, "float32"),
    ("signum", {"learning_rate": 0.01, "wd_lh": 0.1}, "float32"),
    ("signsgd", {"learning_rate": 0.01, "wd": 1e-3}, "float32"),
]


@pytest.mark.parametrize("opt,args,dtype", FUSED_CASES, ids=[
    "-".join([o] + sorted(a) + [d]) for o, a, d in FUSED_CASES])
def test_fused_bitexact(monkeypatch, opt, args, dtype):
    """Fused and loop give the same bits in weights and states, and the
    same update counts, across lr changes and batch-size (rescale_grad)
    changes, with an lr_mult and a wd_mult."""
    lr_seq = [0.05, 0.02, 0.05, 0.01]
    batch_seq = [32, 16, 64]
    a, tr_a = _run(monkeypatch, opt, args, True, lr_seq=lr_seq,
                   batch_seq=batch_seq, dtype=dtype)
    b, tr_b = _run(monkeypatch, opt, args, False, lr_seq=lr_seq,
                   batch_seq=batch_seq, dtype=dtype)
    for i, (wa, wb) in enumerate(zip(a, b)):
        assert wa.dtype == getattr(torch, dtype)
        assert torch.equal(wa, wb), f"param {i} differs (not bit-exact)"
    assert tr_b._fused.fallbacks == {"env_disabled": 5}
    assert tr_a.optimizer._index_update_count == \
        tr_b.optimizer._index_update_count
    assert tr_a.optimizer.num_update == tr_b.optimizer.num_update
    sa, sb = tr_a._updaters[0].states, tr_b._updaters[0].states
    assert sorted(sa) == sorted(sb)
    for k in sa:
        for la, lb in zip(_leaves(sa[k]), _leaves(sb[k]), strict=True):
            assert torch.equal(la, lb), f"state {k} differs"


def test_fused_bitexact_with_loss_scaler(monkeypatch):
    """The loss scaler's rescale is a per-step scalar: scaled runs stay
    bit-exact with the loop."""
    mk = lambda: amp.LossScaler(init_scale=64.0,  # noqa: E731
                                target_dtype="float16")
    args = {"learning_rate": 0.05, "momentum": 0.9}
    a, tr = _run(monkeypatch, "sgd", args, True, scaler=mk)
    b, _ = _run(monkeypatch, "sgd", args, False, scaler=mk)
    for wa, wb in zip(a, b):
        assert torch.equal(wa, wb)
    assert tr._fused.programs_built == 1


def test_lr_change_does_not_recompile(monkeypatch):
    """After the first step records the program, lr and batch-size
    changes reuse it: no new program, no launch table, no kernel build,
    and every step fused."""
    monkeypatch.setenv("MXNET_TPU_FUSED_UPDATE", "1")
    params = _make_params(n=5, seed=3)
    trainer = Trainer(params, "adam", {"learning_rate": 1e-3})
    _set_grads(params, 0)
    trainer.step(8)
    fused = trainer._fused
    built = (fused.programs_built, fused.tables_built, kernels.build_count())
    assert fused.programs_built == 1
    for s in range(4):
        trainer.set_learning_rate(1e-3 * (s + 1))
        _set_grads(params, s + 1)
        trainer.step(8 + 4 * s)
        assert fused.last_dispatches == 1
    assert (fused.programs_built, fused.tables_built,
            kernels.build_count()) == built
    assert fused.fallbacks == {}


@pytest.mark.parametrize("n", [2, 200])
def test_single_dispatch_regardless_of_param_count(monkeypatch, n):
    """One dispatch a step for 2 and for 200 parameters; the loop on
    the same parameters runs the op once per parameter (the counter
    counts real passes)."""
    calls = []
    real_multi = tops.multi_update

    def counting_multi(name, *a, **kw):
        calls.append(name)
        return real_multi(name, *a, **kw)
    monkeypatch.setattr(tops, "multi_update", counting_multi)
    twin_calls = []
    rule = tops.RULES["sgd_mom_update"]
    real_twin = rule.twin

    def counting_twin(*a, **kw):
        twin_calls.append(1)
        return real_twin(*a, **kw)
    monkeypatch.setattr(rule, "twin", counting_twin)

    monkeypatch.setenv("MXNET_TPU_FUSED_UPDATE", "1")
    params = _make_params(n=n, seed=1)
    trainer = Trainer(params, "sgd", {"learning_rate": 0.1,
                                      "momentum": 0.9})
    for s in range(2):
        _set_grads(params, s)
        del calls[:], twin_calls[:]
        trainer.step(8)
        assert trainer._fused.last_dispatches == 1
        assert calls == ["sgd_mom_update"]
        assert len(twin_calls) == n
    monkeypatch.setenv("MXNET_TPU_FUSED_UPDATE", "0")
    _set_grads(params, 2)
    del calls[:], twin_calls[:]
    trainer.step(8)
    assert calls == [] and len(twin_calls) == n


class _Custom(topt.SGD):
    """An optimizer outside the fusable set (a user's subclass)."""


def test_fallback_paths(monkeypatch):
    """Every reason label: the loop runs and gives the loop's numbers."""
    monkeypatch.setenv("MXNET_TPU_FUSED_UPDATE", "1")

    def run(opt, args, seed, **step_kw):
        params = _make_params(n=3, seed=seed)
        trainer = Trainer(params, opt, args)
        _set_grads(params, 0)
        trainer.step(4, **step_kw)
        return trainer, [p.data().detach().clone() for p in params]

    trainer, _ = run("sgd", {"learning_rate": 0.1}, 4,
                     ignore_stale_grad=True)
    assert trainer._fused.fallbacks == {"ignore_stale_grad": 1}
    # unfusable optimizers: a class outside the set, generic mp (Adam)
    trainer, _ = run(_Custom(learning_rate=0.1), None, 5)
    assert trainer._fused.fallbacks == {"optimizer": 1}
    trainer, _ = run("adam", {"multi_precision": True}, 5)
    assert trainer._fused.fallbacks == {"optimizer": 1}
    # an int static hyperparameter (Ftrl's default beta=1), as the
    # reference: it records nothing replayable, sticky for the trainer
    trainer, got = run("ftrl", {"learning_rate": 0.1}, 6)
    assert trainer._fused.fallbacks == {"unrecordable": 1}
    assert trainer.optimizer._index_update_count == {0: 1, 1: 1, 2: 1}
    monkeypatch.setenv("MXNET_TPU_FUSED_UPDATE", "0")
    ref, want = run("ftrl", {"learning_rate": 0.1}, 6)
    assert ref._fused.fallbacks == {"env_disabled": 1}
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("share", ["same_tensor", "view"])
def test_aliased_parameters_take_the_loop(monkeypatch, share):
    """Two parameters over one storage (one tensor, or a view into
    another's rows): one launch would update it in a race, so the step
    takes the loop, which updates it twice as the reference's loop does;
    parameters apart take the fused path."""
    def run(fused):
        monkeypatch.setenv("MXNET_TPU_FUSED_UPDATE", "1" if fused else "0")
        params = _make_params(n=4, seed=7)
        base = params[0].data().detach()
        shared = base if share == "same_tensor" else base[1:]
        params[3] = Parameter("alias", shape=shared.shape)
        params[3]._adopt(torch.nn.Parameter(shared))
        trainer = Trainer(params, "sgd", {"learning_rate": 0.1,
                                          "momentum": 0.9})
        for s in range(2):
            _set_grads(params, s)
            trainer.step(4)
        return trainer, [p.data().detach().clone() for p in params]

    tr_a, a = run(True)
    tr_b, b = run(False)
    assert tr_a._fused.fallbacks == {"aliased": 2}
    for wa, wb in zip(a, b):
        assert torch.equal(wa, wb)
    monkeypatch.setenv("MXNET_TPU_FUSED_UPDATE", "1")
    apart = _make_params(n=4, seed=7)
    tr = Trainer(apart, "sgd", {"learning_rate": 0.1, "momentum": 0.9})
    _set_grads(apart, 0)
    tr.step(4)
    assert tr._fused.fallbacks == {} and tr._fused.last_dispatches == 1


def test_fused_state_checkpoint_roundtrip(monkeypatch, tmp_path):
    """States written by the fused path save and load through the
    Trainer's states file (numpy arrays) bit for bit, and the loaded
    trainer goes on fused, matching the uninterrupted run (Adam: the
    update counts travel with the optimizer, restored here as the
    reference's full checkpoint restores them)."""
    monkeypatch.setenv("MXNET_TPU_FUSED_UPDATE", "1")
    params = _make_params(n=4, seed=10)
    trainer = Trainer(params, "adam", {"learning_rate": 1e-3})
    for s in range(3):
        _set_grads(params, s)
        trainer.step(8)
    fname = str(tmp_path / "adam.states")
    trainer.save_states(fname)
    after3 = [p.data().detach().clone() for p in params]
    _set_grads(params, 3)
    trainer.step(8)
    after4 = [p.data().detach().clone() for p in params]

    params2 = _make_params(n=4, seed=11)
    for p, w in zip(params2, after3):
        p.set_data(w)
    trainer2 = Trainer(params2, "adam", {"learning_rate": 1e-3})
    trainer2.load_states(fname)
    trainer2.optimizer._index_update_count = dict(
        trainer.optimizer._index_update_count)
    for k in trainer2.optimizer._index_update_count:
        trainer2.optimizer._index_update_count[k] -= 1
    trainer2.optimizer.num_update = 3
    _set_grads(params2, 3)
    trainer2.step(8)
    assert trainer2._fused.fallbacks == {}
    assert trainer2._fused.last_dispatches == 1
    for wa, p in zip(after4, params2):
        assert torch.equal(wa, p.data()), \
            "resumed step diverged from the uninterrupted run"

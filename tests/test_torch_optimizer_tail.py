"""PyTorch port, the optimizer tail: the reference's 20 registered
optimizers (the eleven new ones: AdaDelta, Adamax, Nadam, FTML, LAMB,
LARS, DCASGD, SGLD, LBSGD, GroupAdaGrad, Test), the LAMB ops with their
mp variants in bf16 and f16, the new optimizers' states through
``Updater.get_states`` / ``set_states`` and ``Trainer.save_states`` /
``load_states``, and a small gluon net trained with each new optimizer,
against the JAX package on the same numpy inputs, on the CPU.

Tolerances: f32 weights and states after three updates rtol 1e-5 / atol
1e-6 (the same operations in the same order; XLA may contract or
reorder within one op, LARS's and LBSGD's host norms are sums in
another order, GroupAdaGrad's row mean is a sum in another order);
the mp ops in bf16/f16: the f32 outputs rtol 1e-5 / atol 1e-6, the 16-bit
weight within one rounding of its dtype (2^-7 bf16, 2^-10 f16,
relative); the two-step nets rtol 1e-4 / atol 1e-5 (gradients through
two layers). SGLD draws its noise from the port's own stream: it is held
by the noise's mean and variance (4 standard errors) on 2^16 elements.
"""
import os
import pickle
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import jax.numpy as jnp  # noqa: E402
import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.autograd as jag  # noqa: E402
from mxnet_tpu import gluon as jgluon  # noqa: E402
from mxnet_tpu import optimizer as jopt  # noqa: E402
from mxnet_tpu.ops import registry as jreg  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu_torch import _rng  # noqa: E402
from mxnet_tpu_torch import autograd as ag  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch import nd as tnd  # noqa: E402
from mxnet_tpu_torch import optimizer as topt  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)
NET_TOL = dict(rtol=1e-4, atol=1e-5)
ALL = ["sgd", "nag", "adam", "adamw", "adagrad", "adadelta", "adamax",
       "nadam", "rmsprop", "ftml", "ftrl", "lamb", "lars", "dcasgd", "sgld",
       "signum", "signsgd", "lbsgd", "groupadagrad", "test"]
NEW = ["adadelta", "adamax", "nadam", "ftml", "lamb", "lars", "dcasgd",
       "sgld", "lbsgd", "groupadagrad", "test"]
# options that put every branch of an optimizer in play
KWARGS = {"lars": {"momentum": 0.9}, "dcasgd": {"momentum": 0.9},
          "lbsgd": {"momentum": 0.9, "warmup_strategy": "power2",
                    "batch_scale": 4, "warmup_epochs": 1,
                    "updates_per_epoch": 4},
          "lamb": {"lower_bound": 0.5, "upper_bound": 4.0},
          "nadam": {"wd": 0.01}, "adamax": {"clip_gradient": 0.8},
          "ftml": {"wd": 0.01, "rescale_grad": 0.5}}


def _setup(shape=(4, 7), seed=0):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-1, 1, shape).astype(np.float32),
            rs.uniform(-1, 1, shape).astype(np.float32))


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    return [state]


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.asnumpy(), np.float32)


def _step_both(name, kwargs, w_np, g_np, nsteps=3):
    """``nsteps`` updates of index 0 by both packages' optimizer on the
    same weight and gradient: (port's weight, states), (reference's)."""
    to = topt.create(name, **kwargs)
    jo = jopt.create(name, **kwargs)
    w = torch.from_numpy(w_np.copy())
    jw = mx.nd.array(w_np)
    ts, js = to.create_state(0, w), jo.create_state(0, jw)
    for _ in range(nsteps):
        to.update(0, w, torch.from_numpy(g_np.copy()), ts)
        jo.update(0, jw, mx.nd.array(g_np), js)
    return (w, ts, to), (jw, js, jo)


def test_create_resolves_every_reference_name():
    assert sorted(topt.Optimizer.opt_registry) == \
        sorted(jopt.Optimizer.opt_registry) == sorted(ALL)
    for name in ALL:
        assert type(topt.create(name)).__name__ == \
            type(jopt.create(name)).__name__


@pytest.mark.parametrize("name", ALL)
def test_optimizer_steps_like_the_reference(name):
    """Three updates of every registered optimizer on the same weight and
    gradient: weight and states as the reference's (SGLD: the
    deterministic part and the states; its noise below)."""
    kwargs = dict(KWARGS.get(name, {}))
    w_np, g_np = _setup()
    (w, ts, to), (jw, js, jo) = _step_both(name, kwargs, w_np, g_np)
    assert np.all(np.isfinite(w.numpy())) and not np.allclose(w.numpy(),
                                                               w_np)
    if name == "sgld":
        return
    np.testing.assert_allclose(w.numpy(), jw.asnumpy(), **TOL)
    tl, jl = _leaves(ts), _leaves(js)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(_as_np(a), _as_np(b), **TOL)
    if name == "nadam":
        assert to.m_schedule == pytest.approx(jo.m_schedule, rel=1e-12)


def test_sgld_noise_statistics():
    """SGLD's step minus its deterministic part is N(0, lr): mean and
    variance within 4 standard errors on 2^16 elements, on both
    packages; the port's draws repeat under one seed."""
    lr = 0.04
    n = 1 << 16
    w_np = np.zeros(n, np.float32)
    g_np = np.full(n, 0.5, np.float32)
    want = w_np - lr / 2 * g_np
    got = []
    for seed in (3, 3):
        _rng.seed(seed)
        mx.random.seed(seed)
        (w, _, _), (jw, _, _) = _step_both("sgld", {"learning_rate": lr},
                                           w_np, g_np, nsteps=1)
        got.append(w.numpy().copy())
        for noise in (w.numpy() - want, jw.asnumpy() - want):
            assert abs(noise.mean()) < 4 * np.sqrt(lr / n)
            assert abs(noise.var() - lr) < 4 * lr * np.sqrt(2.0 / n)
    assert np.array_equal(got[0], got[1])


def test_multi_precision_steps_on_16bit_weights():
    """``multi_precision=True`` on bf16 and f16 weights: the f32 master
    copy is the reference's; the weight is the master rounded once."""
    w_np, g_np = _setup(seed=1)
    for name in NEW:
        if name in ("sgld", "test"):
            continue
        for tdt, jdt, eps in ((torch.bfloat16, "bfloat16", 2.0 ** -7),
                              (torch.float16, "float16", 2.0 ** -10)):
            kw = dict(KWARGS.get(name, {}), multi_precision=True)
            to, jo = topt.create(name, **kw), jopt.create(name, **kw)
            w = torch.from_numpy(w_np).to(tdt)
            jw = mx.nd.array(w_np, dtype=jdt)
            ts = to.create_state_multi_precision(0, w)
            js = jo.create_state_multi_precision(0, jw)
            for _ in range(2):
                to.update_multi_precision(0, w, torch.from_numpy(g_np).to(
                    tdt), ts)
                jo.update_multi_precision(0, jw, mx.nd.array(g_np,
                                                             dtype=jdt), js)
            assert w.dtype == tdt and ts[1].dtype == torch.float32
            np.testing.assert_allclose(ts[1].numpy(), _as_np(js[1]), **TOL)
            np.testing.assert_allclose(
                w.float().numpy(), ts[1].numpy(), rtol=eps, atol=1e-6,
                err_msg=f"{name} {jdt}")


# ----------------------------------------------- the LAMB ops directly --
def _lamb_inputs(dtype, seed=4, shape=(6, 5)):
    rs = np.random.RandomState(seed)
    w32 = rs.randn(*shape).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    m = (rs.rand(*shape).astype(np.float32) - 0.5) * 0.2
    v = rs.rand(*shape).astype(np.float32) * 0.5 + 0.1
    return w32, g, m, v


def _pair(a, tdt, jdt):
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16", "float16"])
def test_lamb_ops_match_the_reference(dt):
    """``lamb_update_phase1/2`` (f32) and ``mp_lamb_update_phase1/2``
    (16-bit weight and gradient, f32 states and master) on the same
    inputs, with the int ``t`` and both bounds."""
    tdt, jdt = getattr(torch, dt), getattr(jnp, dt)
    w32, g, m, v = _lamb_inputs(dt)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, t=3, wd=0.01,
              rescale_grad=0.5, clip_gradient=1.0, bias_correction=True)
    if dt == "float32":
        names = ("lamb_update_phase1", "lamb_update_phase2")
        t_in = [torch.from_numpy(a.copy()) for a in (w32, g, m, v)]
        j_in = [jnp.asarray(a) for a in (w32, g, m, v)]
    else:
        names = ("mp_lamb_update_phase1", "mp_lamb_update_phase2")
        tw, jw = _pair(w32, tdt, jdt)
        tg, jg = _pair(g, tdt, jdt)
        t_in = [tw, tg, torch.from_numpy(m), torch.from_numpy(v),
                torch.from_numpy(w32)]
        j_in = [jw, jg, jnp.asarray(m), jnp.asarray(v), jnp.asarray(w32)]
    got1 = treg.get(names[0]).impl(*t_in, **kw)
    want1 = jreg.get(names[0]).impl(*j_in, **kw)
    for a, b in zip(got1, want1):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    r1, r2 = np.float32(2.5), np.float32(0.5)
    for lo, hi in ((-1.0, -1.0), (6.0, -1.0), (-1.0, 2.0)):
        kw2 = dict(lr=0.05, lower_bound=lo, upper_bound=hi)
        tx = [t_in[0], got1[0], torch.tensor(r1), torch.tensor(r2)]
        jx = [j_in[0], want1[0], jnp.asarray(r1), jnp.asarray(r2)]
        if dt != "float32":
            tx.append(t_in[4])
            jx.append(j_in[4])
        got2 = treg.get(names[1]).impl(*tx, **kw2)
        want2 = jreg.get(names[1]).impl(*jx, **kw2)
        got2 = got2 if isinstance(got2, tuple) else (got2,)
        want2 = want2 if isinstance(want2, tuple) else (want2,)
        for a, b in zip(got2, want2):
            assert str(a.dtype)[6:] == str(b.dtype)
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32), **TOL)
    for name in names:
        top, jop = treg.get(name), jreg.get(name)
        assert (top.nout, top.mutates) == (jop.nout, jop.mutates)
        assert not top.differentiable


@pytest.mark.parametrize("mp", [False, True])
def test_multi_lamb_matches_per_tensor_phases(mp):
    """``_multi_lamb_update`` / ``_multi_mp_lamb_update`` over three
    tensors against the JAX ops, and against the per-tensor route
    (phase 1, the two norms, phase 2) of the port."""
    name = "_multi_mp_lamb_update" if mp else "_multi_lamb_update"
    shapes = ((3, 4), (5,), (2, 2, 3))
    t_arr, j_arr, per = [], [], []
    for k, shape in enumerate(shapes):
        w32, g, m, v = _lamb_inputs("float32", seed=10 + k, shape=shape)
        group = [w32, g, m, v] + ([w32] if mp else [])
        t_arr += [torch.from_numpy(a.copy()) for a in group]
        j_arr += [jnp.asarray(a) for a in group]
        per.append(group)
    kw = dict(learning_rates=(0.01, 0.02, 0.05), wds=(0.0, 0.01, 0.1),
              step_count=(1, 2, 5), beta1=0.9, beta2=0.999, epsilon=1e-6,
              rescale_grad=1.0, clip_gradient=-1.0)
    got = treg.get(name).impl(t_arr, **kw)
    want = jreg.get(name).impl(j_arr, **kw)
    assert len(got) == len(want) == 3 * (4 if mp else 3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    n_out = 4 if mp else 3
    for k, (w32, g, m, v, *_r) in enumerate(per):
        step, m1, v1 = treg.get("lamb_update_phase1").impl(
            *(torch.from_numpy(a) for a in (w32, g, m, v)), beta1=0.9,
            beta2=0.999, epsilon=1e-6, t=kw["step_count"][k],
            wd=kw["wds"][k])
        w = torch.from_numpy(w32)
        r1, r2 = w.norm(), step.norm()
        new = treg.get("lamb_update_phase2").impl(
            w, step, r1, r2, lr=kw["learning_rates"][k])
        for a, b in zip((new, m1, v1), got[k * n_out:k * n_out + 3]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_lamb_t_stays_a_static_int():
    """The fused path's hyperparameter split keeps LAMB's ``t`` out of
    the per-step floats."""
    from mxnet_tpu_torch.ops import invoke
    static, tkeys, _ = invoke._split_hyper(dict(t=7, lr=0.1, wd=0.0,
                                                beta1=0.9))
    assert ("t", 7) in static and "t" not in tkeys
    assert not topt.fusable(topt.LAMB())


# ------------------------------------------------------------- states --
@pytest.mark.parametrize("name", NEW)
def test_state_round_trip_matches_the_reference_layout(name):
    """Two steps, ``get_states`` into a fresh updater, two more steps:
    the reference's state layout (tuples, None parts, GroupAdaGrad's
    per-row history), values as an uninterrupted run, bit for bit."""
    kwargs = dict(KWARGS.get(name, {}))
    w_np, g_np = _setup(seed=2)
    g = torch.from_numpy(g_np)
    ref_upd = topt.get_updater(topt.create(name, **kwargs))
    w_ref = torch.from_numpy(w_np.copy())
    jupd = jopt.get_updater(jopt.create(name, **kwargs))
    jw = mx.nd.array(w_np)
    upd = topt.get_updater(topt.create(name, **kwargs))
    w = torch.from_numpy(w_np.copy())
    for _ in range(2):
        _rng.seed(9)
        ref_upd(0, g, w_ref)
        _rng.seed(9)
        upd(0, g, w)
        jupd(0, mx.nd.array(g_np), jw)
    host = pickle.loads(upd.get_states())

    def layout(s):
        if s is None:
            return None
        if isinstance(s, (tuple, list)):
            return tuple(layout(x) for x in s)
        return tuple(np.shape(s))
    assert layout(host[0]) == layout(jupd.states[0])
    upd2 = topt.get_updater(topt.create(name, **kwargs))
    upd2.optimizer._index_update_count = dict(
        upd.optimizer._index_update_count)
    if name == "nadam":
        upd2.optimizer.m_schedule = upd.optimizer.m_schedule
    upd2.set_states(upd.get_states())
    for _ in range(2):
        _rng.seed(10)
        ref_upd(0, g, w_ref)
        _rng.seed(10)
        upd2(0, g, w)
    assert torch.equal(w, w_ref)
    for a, b in zip(_leaves(upd2.states[0]), _leaves(ref_upd.states[0])):
        assert torch.equal(a, b)


def test_trainer_save_and_load_states(tmp_path):
    """``Trainer.save_states`` / ``load_states`` with LAMB's pair and
    DCASGD's (None, previous weight)."""
    for name, kw in (("lamb", {}), ("dcasgd", {})):
        net = tgluon.nn.Dense(3, in_units=4, prefix=f"st_{name}_")
        net.initialize(device="cpu")
        tr = tgluon.Trainer(net.collect_params(), name, dict(kw))
        x = tnd.array(np.ones((2, 4), np.float32), ctx="cpu")
        with ag.record():
            loss = net(x).sum()
        loss.backward()
        tr.step(2)
        f = str(tmp_path / f"{name}.states")
        tr.save_states(f)
        saved = {k: [s.copy() if isinstance(s, np.ndarray) else s
                     for s in (v if isinstance(v, tuple) else (v,))]
                 for k, v in pickle.loads(open(f, "rb").read()).items()}
        tr2 = tgluon.Trainer(net.collect_params(), name, dict(kw))
        tr2.load_states(f)
        for k, v in tr2._updaters[0].states.items():
            v = v if isinstance(v, tuple) else (v,)
            for a, b in zip(v, saved[k]):
                assert (a is None and b is None) or np.array_equal(
                    np.asarray(a), b)


# ------------------------------------------------------ the gluon net --
def _nets(seed):
    rs = np.random.RandomState(seed)
    values = {"0_weight": rs.randn(5, 4).astype(np.float32) * 0.5,
              "0_bias": rs.randn(5).astype(np.float32) * 0.1,
              "1_weight": rs.randn(3, 5).astype(np.float32) * 0.5,
              "1_bias": rs.randn(3).astype(np.float32) * 0.1}
    out = []
    for g, kw in ((tgluon, {"device": "cpu"}), (jgluon, {})):
        net = g.nn.HybridSequential(prefix="tailnet_")
        with net.name_scope():
            net.add(g.nn.Dense(5, in_units=4, activation="tanh",
                               prefix="d0_"))
            net.add(g.nn.Dense(3, in_units=5, prefix="d1_"))
        net.initialize(**kw)
        for k, p in net.collect_params().items():
            layer = "0" if "d0_" in k else "1"
            v = values[f"{layer}_{k.rsplit('_', 1)[1]}"]
            p.set_data(torch.from_numpy(v.copy()) if g is tgluon
                       else mx.nd.array(v))
        out.append(net)
    return out


@pytest.mark.parametrize("name", NEW)
def test_gluon_net_trains_like_the_reference(name):
    """Two Trainer steps of a two-layer net (tanh) with each new
    optimizer, L2 loss, batch 6: the weights the reference's Trainer
    gives from the same start (SGLD: finite and moved; its noise is
    held by statistics above)."""
    net, jnet = _nets(5)
    rs = np.random.RandomState(6)
    x = rs.randn(6, 4).astype(np.float32)
    y = rs.randn(6, 3).astype(np.float32)
    kw = dict(KWARGS.get(name, {}))
    kw.pop("rescale_grad", None)
    tr = tgluon.Trainer(net.collect_params(), name, dict(kw))
    jtr = jgluon.Trainer(jnet.collect_params(), name, dict(kw))
    loss_fn, jloss_fn = tgluon.loss.L2Loss(), jgluon.loss.L2Loss()
    before = [p.data().detach().clone() for p in
              net.collect_params().values()]
    for _ in range(2):
        with ag.record():
            loss = loss_fn(net(tnd.array(x, ctx="cpu")),
                           tnd.array(y, ctx="cpu"))
        ag.backward(loss)
        tr.step(6)
        with jag.record():
            jloss = jloss_fn(jnet(mx.nd.array(x)), mx.nd.array(y))
        jloss.backward()
        jtr.step(6)
    assert tr._fused.fallbacks == {"optimizer": 2}
    tparams = sorted(net.collect_params().items())
    jparams = sorted(jnet.collect_params().items())
    for (tk, tp), (jk, jp), b in zip(tparams, jparams, before):
        got = tp.data().detach().numpy()
        assert np.all(np.isfinite(got)) and not np.array_equal(got,
                                                               b.numpy())
        if name != "sgld":
            np.testing.assert_allclose(got, jp.data().asnumpy(),
                                       err_msg=f"{name} {tk}", **NET_TOL)

"""PyTorch port, optimizers: the update ops, the nine fusable optimizers,
the lr schedulers, the ``Updater`` and the Trainer's states file of
``mxnet_tpu_torch`` against the JAX package's, on the same numpy inputs
(the port's counterparts of ``tests/test_optimizer.py:28-150``).

On the CPU the update ops run their plain twins
(``mxnet_tpu_torch/ops/optimizer_ops.py``); the multi-tensor kernel is
held against them bit for bit on the card (``tests/test_torch_cuda.py``).

Tolerance: ``OPT_TOL = 1e-6`` (``test_torch_gluon.py``'s): weights and
states after three updates on the same gradients: the same elementwise
f32 update, lr at most 0.1; only the last bit of each operation may
differ (XLA may contract or reorder what the port rounds one operation
at a time). The schedulers are pure Python on both sides and match
exactly; the port's own round trips are held bit for bit.
"""
import os
import pickle
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import lr_scheduler as jsched  # noqa: E402
from mxnet_tpu import optimizer as jopt  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch import lr_scheduler as tsched  # noqa: E402
from mxnet_tpu_torch import nd as tnd  # noqa: E402
from mxnet_tpu_torch import optimizer as topt  # noqa: E402
from mxnet_tpu_torch.gluon.parameter import Parameter  # noqa: E402
from mxnet_tpu_torch.ops import optimizer_ops as tops  # noqa: E402
from mxnet_tpu_torch.ops.invoke import apply_op  # noqa: E402
from mxnet_tpu_torch.ops.registry import get as get_op  # noqa: E402

torch.set_num_threads(2)

OPT_TOL = 1e-6
SHAPES = ((4, 7), (5,), (3, 2, 2))

# (optimizer, kwargs, weight dtype): momentum, clip, wd, lr_mult (index
# 0 at 0.5, through set_lr_mult) and multi-precision on and off
CASES = [
    ("sgd", dict(learning_rate=0.1), "float32"),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01,
                 clip_gradient=0.5), "float32"),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01,
                 multi_precision=True), "float16"),
    ("sgd", dict(learning_rate=0.1, multi_precision=True,
                 clip_gradient=0.5), "float16"),
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=0.01,
                 clip_gradient=0.5), "float32"),
    ("nag", dict(learning_rate=0.1), "float32"),
    ("adam", dict(learning_rate=0.01, wd=0.01, clip_gradient=0.5),
     "float32"),
    ("adam", dict(learning_rate=0.01, beta1=0.8, multi_precision=True),
     "float16"),
    ("adamw", dict(learning_rate=0.01, wd=0.01, eta=0.9, clip_gradient=0.5),
     "float32"),
    ("adagrad", dict(learning_rate=0.1, wd=0.01, clip_gradient=0.5),
     "float32"),
    ("rmsprop", dict(learning_rate=0.01, wd=0.01), "float32"),
    ("rmsprop", dict(learning_rate=0.01, centered=True, clip_weights=0.8,
                     clip_gradient=0.5), "float32"),
    ("ftrl", dict(learning_rate=0.1, lamda1=0.05, wd=0.01,
                  clip_gradient=0.5), "float32"),
    ("signum", dict(learning_rate=0.01, momentum=0.9, wd=0.01, wd_lh=0.1),
     "float32"),
    ("signsgd", dict(learning_rate=0.01, wd=0.01, clip_gradient=0.5),
     "float32"),
]


def _ids(case):
    name, kw, dtype = case
    return "-".join([name] + sorted(kw) + [dtype])


def _inputs(seed):
    rng = np.random.RandomState(seed)
    ws = [rng.uniform(-1, 1, s).astype(np.float32) for s in SHAPES]
    gs = [[rng.uniform(-1, 1, s).astype(np.float32) for s in SHAPES]
          for _ in range(3)]
    return ws, gs


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    return [state]


def _f32(a):
    return np.asarray(a, dtype=np.float32)


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_optimizer_three_updates_match_jax(case):
    name, kw, dtype = case
    ws, gs = _inputs(0)
    jo, to = jopt.create(name, **kw), topt.create(name, **kw)
    for o in (jo, to):
        o.set_lr_mult({0: 0.5})
        o.set_wd_mult({2: 0.0})
    tdt = getattr(torch, dtype)
    jw = [mx.nd.array(w.astype(dtype), dtype=dtype) for w in ws]
    tw = [torch.from_numpy(w).to(tdt) for w in ws]
    js = [jo.create_state_multi_precision(i, w) for i, w in enumerate(jw)]
    ts = [to.create_state_multi_precision(i, w) for i, w in enumerate(tw)]
    for step in range(3):
        for i in range(len(SHAPES)):
            g = gs[step][i].astype(dtype)
            jo.update_multi_precision(i, jw[i], mx.nd.array(g, dtype=dtype),
                                      js[i])
            to.update_multi_precision(i, tw[i], torch.from_numpy(g).to(tdt),
                                      ts[i])
        for i in range(len(SHAPES)):
            np.testing.assert_allclose(
                tw[i].float().numpy(), _f32(jw[i].asnumpy()), rtol=OPT_TOL,
                atol=OPT_TOL, err_msg=f"{name} weight {i} after step {step}")
            jl, tl = _leaves(js[i]), _leaves(ts[i])
            assert len(jl) == len(tl)
            for a, b in zip(jl, tl):
                np.testing.assert_allclose(
                    b.float().numpy(), _f32(a.asnumpy()), rtol=OPT_TOL,
                    atol=OPT_TOL, err_msg=f"{name} state {i} step {step}")
    assert to._index_update_count == jo._index_update_count
    assert to.num_update == jo.num_update


@pytest.mark.parametrize("name", sorted(tops.RULES))
def test_update_op_writes_in_place_like_the_jax_op(name):
    """Each update op through ``apply_op`` (and ``nd``): the weight and
    the states are written in place, to the JAX op's results."""
    rule = tops.RULES[name]
    rng = np.random.RandomState(5)
    low = torch.float16 if rule.mp else torch.float32
    arrays = [rng.uniform(0.1, 1, (3, 5)).astype(np.float32)
              for _ in range(rule.n_in)]
    arrays[:2] = [a.astype(np.float16 if rule.mp else np.float32)
                  for a in arrays[:2]]
    kw = dict(lr=0.05, wd=0.01, rescale_grad=0.5, clip_gradient=0.8)
    if "mom" in name or name.startswith("signum") or "alex" in name:
        kw["momentum"] = 0.9
    if name == "ftml_update":             # FTML names its clip clip_grad
        kw["clip_grad"] = kw.pop("clip_gradient")
    want = mx.nd.__dict__[name](*(mx.nd.array(a, dtype=a.dtype)
                                  for a in arrays), **kw)
    want = want if isinstance(want, (tuple, list)) else (want,)
    xs = [torch.from_numpy(a.copy()) for a in arrays]
    ids = [id(x) for x in xs]
    got = getattr(tnd, name)(*xs, **kw)
    got = got if isinstance(got, tuple) else (got,)
    assert [id(g) for g in got] == [ids[m] for m in rule.mutates]
    assert xs[0].dtype == (low if rule.mp else torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), _f32(w.asnumpy()),
                                   rtol=OPT_TOL, atol=OPT_TOL)
    assert get_op(name).mutates == rule.mutates


def test_update_ops_take_positional_hyperparameters():
    w, g = torch.ones(3), torch.full((3,), 2.0)
    tnd.sgd_update(w, g, 0.25)                # lr by position
    assert torch.equal(w, torch.full((3,), 0.5))
    apply_op("sgd_update", [w, g], {"lr": 0.25, "wd": 0.0})
    assert torch.equal(w, torch.zeros(3))


def test_kernel_inputs_and_scalar_rows():
    """What the kernel takes (checked before a launch table is built) and
    the scalar rows it reads: each scalar rounded to f32 once."""
    xs = [torch.ones(4), torch.ones(4)]
    with pytest.raises(ValueError, match="contiguous"):
        tops._check_inputs(tops.RULES["sgd_update"],
                           [torch.ones(4, 2).t(), torch.ones(2, 4)])
    with pytest.raises(TypeError, match="float32"):
        tops._check_inputs(tops.RULES["sgd_update"],
                           [xs[0].double(), xs[1]])
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        tops._check_inputs(tops.RULES["mp_sgd_update"],
                           [*xs, torch.ones(4)])
    g = torch.ones(3)
    rows = tops.scalar_rows("adam_update", [dict(lr=0.1, beta1=0.8)], [g])
    assert rows.shape == (1, tops.SCALAR_ROW) and rows.dtype == np.float32
    # (1 - beta1) rounded once from the double, not 1 - f32(beta1)
    assert rows[0, 2] == np.float32(1 - 0.8)
    # the gradient's address in the row's last eight bytes
    assert rows.view(np.int64)[0, -1] == g.data_ptr()
    assert tops.bytes_per_element("adam_update") == 28
    assert tops.bytes_per_element("mp_sgd_mom_update", torch.bfloat16) == 20


# ------------------------------------------------------------ schedulers --
SCHEDULERS = [
    ("FactorScheduler", dict(step=3, factor=0.5, base_lr=1.0,
                             warmup_steps=4, warmup_begin_lr=0.1)),
    ("MultiFactorScheduler", dict(step=[5, 9], factor=0.3, base_lr=0.5,
                                  warmup_steps=3, warmup_mode="constant",
                                  warmup_begin_lr=0.05)),
    ("PolyScheduler", dict(max_update=20, base_lr=1.0, pwr=2, final_lr=0.1,
                           warmup_steps=5)),
    ("CosineScheduler", dict(max_update=20, base_lr=1.0, final_lr=0.05,
                             warmup_steps=5, warmup_begin_lr=0.2)),
]


@pytest.mark.parametrize("name,kw", SCHEDULERS, ids=[s[0] for s in
                                                     SCHEDULERS])
def test_scheduler_with_warmup_matches_jax(name, kw):
    js = getattr(jsched, name)(**dict(kw))
    ts = getattr(tsched, name)(**dict(kw))
    updates = list(range(25)) + [30, 22, 40]
    assert [ts(n) for n in updates] == [js(n) for n in updates]


def test_scheduler_drives_trainer_like_jax():
    """A cosine schedule with warmup through the Trainer: per-step lr from
    ``num_update``, held against the JAX Trainer over 5 steps."""
    from mxnet_tpu import gluon as jgluon
    ws, gs = _inputs(1)
    jp = [jgluon.Parameter(f"p{i}", shape=w.shape) for i, w in
          enumerate(ws)]
    tp = [Parameter(f"p{i}", shape=w.shape) for i, w in enumerate(ws)]
    for a, b, w in zip(jp, tp, ws):
        a.initialize()
        a.set_data(mx.nd.array(w))
        b.initialize(device="cpu")
        b.set_data(torch.from_numpy(w))
    kw = dict(max_update=6, base_lr=0.1, final_lr=0.01, warmup_steps=2,
              warmup_begin_lr=0.02)
    jt = jgluon.Trainer(jp, "adam", {"lr_scheduler":
                                     jsched.CosineScheduler(**kw)})
    tt = tgluon.Trainer(tp, "adam", {"lr_scheduler":
                                     tsched.CosineScheduler(**kw)})
    for step in range(5):
        for a, b, g in zip(jp, tp, gs[step % 3]):
            a.grad()[:] = mx.nd.array(g)
            b.grad().copy_(torch.from_numpy(g))
        jt.step(2)
        tt.step(2)
        assert tt.learning_rate == jt.learning_rate
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.data().detach().numpy(),
                                       a.data().asnumpy(), rtol=OPT_TOL,
                                       atol=OPT_TOL)
    with pytest.raises(UserWarning):
        tt.set_learning_rate(0.5)


def test_learning_rate_and_set_learning_rate():
    o = topt.SGD(learning_rate=0.3)
    assert o.learning_rate == 0.3
    o.set_learning_rate(0.05)
    assert o.learning_rate == 0.05
    sched = tsched.MultiFactorScheduler(step=[2], factor=0.1, base_lr=1.0)
    o = topt.SGD(learning_rate=0.5, lr_scheduler=sched)
    assert o.lr == 0.5 and sched.base_lr == 0.5
    w, g = torch.ones(2), torch.zeros(2)
    for _ in range(3):
        o.update(0, w, g, None)
    assert o.num_update == 3
    assert abs(o.learning_rate - 0.05) < 1e-12


def test_optimizer_pickles():
    o = topt.Adam(learning_rate=0.01, beta1=0.8, begin_num_update=4)
    o.set_lr_mult({0: 0.5})
    o._update_count(0)
    back = pickle.loads(pickle.dumps(o))
    assert type(back) is topt.Adam and back.beta1 == 0.8
    assert back.lr_mult == {0: 0.5}
    assert back._index_update_count == {0: 5} and back.num_update == 5


# ------------------------------------------------------ updater states --
def _updater_run(updater, ws, gs, steps):
    for s in steps:
        for i, w in enumerate(ws):
            updater(i, torch.from_numpy(gs[s % 3][i]), w)


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9)),
    ("rmsprop", dict(centered=True)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, multi_precision=True)),
])
def test_updater_state_roundtrip(name, kw):
    """``get_states`` pickles numpy arrays (no tensor, no device); a new
    Updater loading them continues bit for bit."""
    ws, gs = _inputs(2)
    dtype = torch.bfloat16 if kw.get("multi_precision") else torch.float32
    a = [torch.from_numpy(w).to(dtype) for w in ws]
    upd = topt.get_updater(topt.create(name, **kw))
    _updater_run(upd, a, gs, range(2))
    blob = upd.get_states()
    stored = pickle.loads(blob)
    assert sorted(stored) == [0, 1, 2]
    for leaf in _leaves(stored[0]):
        assert isinstance(leaf, np.ndarray)
    b = [w.clone() for w in a]
    upd2 = topt.get_updater(topt.create(name, **kw))
    upd2.set_states(blob)
    assert upd2.states_synced == {0: False, 1: False, 2: False}
    _updater_run(upd, a, gs, [2])
    _updater_run(upd2, b, gs, [2])
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for i in range(3):
        for x, y in zip(_leaves(upd.states[i]), _leaves(upd2.states[i])):
            assert torch.equal(x, y)
    # a bfloat16 state (numpy has none) comes back as bfloat16
    upd3 = topt.get_updater(topt.SGD(momentum=0.9))
    upd3.states[0] = torch.full((2,), 0.5, dtype=torch.bfloat16)
    upd4 = topt.get_updater(topt.SGD(momentum=0.9))
    upd4.set_states(upd3.get_states())
    back = upd4.sync_state_context(upd4.states[0], torch.device("cpu"))
    assert back.dtype == torch.bfloat16 and torch.equal(back,
                                                        upd3.states[0])


def test_trainer_save_and_load_states(tmp_path):
    """``save_states``/``load_states``: a second Trainer loading the file
    continues bit for bit (SGD with momentum: its step needs no count)."""
    ws, gs = _inputs(3)

    def make():
        ps = []
        for i, w in enumerate(ws):
            p = Parameter(f"p{i}", shape=w.shape)
            p.initialize(device="cpu")
            p.set_data(torch.from_numpy(w))
            ps.append(p)
        return ps, tgluon.Trainer(ps, "sgd", {"learning_rate": 0.1,
                                              "momentum": 0.9})

    def step(ps, tr, s):
        for p, g in zip(ps, gs[s % 3]):
            p.grad().copy_(torch.from_numpy(g))
        tr.step(4)

    pa, ta = make()
    for s in range(2):
        step(pa, ta, s)
    fname = str(tmp_path / "trainer.states")
    ta.save_states(fname)
    pb, tb = make()
    for a, b in zip(pa, pb):
        b.set_data(a.data().detach())
    tb.load_states(fname)
    step(pa, ta, 2)
    step(pb, tb, 2)
    for a, b in zip(pa, pb):
        assert torch.equal(a.data(), b.data())
    assert tb._fused.fallbacks == {}       # the loaded states, fused


# ----------------------------------------------- sign's special values --
SPECIALS = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, -1.0, 2.0],
                    np.float32)


@pytest.mark.parametrize("name", ["signsgd_update", "signum_update",
                                  "ftrl_update"])
def test_sign_rules_keep_the_jax_bits_on_nan_zeros_and_inf(name):
    """NaN, ±0 and ±inf gradients (and states, for ftrl) through the
    sign-taking rules: the twin gives the JAX op's bits (jnp.sign keeps
    NaN and the sign of zero)."""
    rule = tops.RULES[name]
    arrays = [np.ones(7, np.float32), SPECIALS.copy()] + [
        np.roll(SPECIALS, k + 1).copy() for k in range(rule.n_in - 2)]
    if name == "ftrl_update":            # n, a sum of squares, >= 0
        arrays[3] = np.abs(arrays[3])
    kw = dict(lr=0.1, wd=0.0)
    if name == "signum_update":
        kw.update(momentum=0.9, wd_lh=0.01)
    want = mx.nd.__dict__[name](*(mx.nd.array(a) for a in arrays), **kw)
    want = want if isinstance(want, (tuple, list)) else (want,)
    xs = [torch.from_numpy(a.copy()) for a in arrays]
    got = getattr(tnd, name)(*xs, **kw)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want, strict=True):
        assert g.numpy().tobytes() == np.asarray(
            w.asnumpy(), np.float32).tobytes(), (name, g, w.asnumpy())


def test_signsgd_nan_gradient_gives_a_nan_weight():
    w = torch.ones(1)
    tnd.signsgd_update(w, torch.tensor([np.nan]), lr=0.1)
    jw = mx.nd.signsgd_update(mx.nd.array(np.ones(1, np.float32)),
                              mx.nd.array(np.array([np.nan], np.float32)),
                              lr=0.1)
    assert np.isnan(jw.asnumpy()[0]) and torch.isnan(w).all()


@pytest.mark.parametrize("name", sorted(
    n for n, r in tops.RULES.items() if r.low16))
def test_low16_rules_take_16bit_weights_and_states(name):
    """A net cast to bfloat16 steps SGD momentum (and the other low16
    rules) on bf16 weights and states without multi_precision, as the
    reference's Trainer does: the kernel's dtype contract and the twin on
    the JAX op's bf16 results (XLA may keep a fused
    chain in f32 where torch rounds each of its up to five ops, so the
    bound is one bf16 ulp of the operands' scale, 1 here)."""
    rule = tops.RULES[name]
    bf = torch.bfloat16
    xs = [torch.ones(4, dtype=bf) for _ in range(rule.n_in)]
    tops._check_inputs(rule, xs)
    with pytest.raises(TypeError, match="bfloat16"):
        tops._check_inputs(rule, [xs[0].float()] + xs[1:])
    assert tops.bytes_per_element(name, bf) == 2 * (2 + 2 * (rule.n_in - 2)
                                                     + 1)
    rng = np.random.RandomState(3)
    arrays = [rng.uniform(0.1, 1, (3, 5)).astype(np.float32)
              for _ in range(rule.n_in)]
    if name == "rmspropalex_update":
        # a mean square at least the squared mean (as the states keep
        # it): sqrt(n - g_avg^2 + eps) stays away from 0
        arrays[2] += 1.0
    kw = dict(lr=0.05, wd=0.01, rescale_grad=0.5)
    if "mom" in name or name.startswith("signum") or "alex" in name:
        kw["momentum"] = 0.9
    want = mx.nd.__dict__[name](*(mx.nd.array(a).astype("bfloat16")
                                  for a in arrays), **kw)
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = getattr(tnd, name)(*(torch.from_numpy(a).to(bf)
                               for a in arrays), **kw)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == bf
        w = np.asarray(w.astype("float32").asnumpy())
        np.testing.assert_allclose(g.float().numpy(), w, rtol=2 ** -7,
                                   atol=2 ** -7)

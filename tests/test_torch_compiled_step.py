"""PyTorch port, the compiled step (``mxnet_tpu_torch/jit.py``,
``Trainer.compile_step``): the one-device cases of
``tests/test_compiled_step.py``.

Each case holds two things on the CPU, where the port's compiled step
runs its step function eagerly (no CUDA graphs):

- the port's ``compile_step`` bit for bit against the port's own eager
  ``record()/backward()/step()`` (the reference's invariant): losses,
  weights, optimizer states and update counts;
- the port against the JAX package's ``compile_step`` on the same numpy
  batches and the same initial weights (the JAX net's, loaded into the
  port's through ``convert.load_gluon_params``), to ``RTOL``/``ATOL``:
  the same f32 arithmetic, XLA fusing and reordering its sums (BatchNorm
  nets: ``BN_RTOL``, the batch statistics reassociate too).

The card's graphs (one replay a step, captures, fresh dropout masks,
persistent update rows) are held in ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 8e.
"""
import os
import sys
import tempfile

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.autograd as jag  # noqa: E402
from mxnet_tpu import gluon as jgluon, nd as jnd  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import amp as tamp, autograd as tag  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon, nd as tnd  # noqa: E402
from mxnet_tpu_torch.convert import load_gluon_params  # noqa: E402
from mxnet_tpu_torch.observability import get_registry  # noqa: E402

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
BN_RTOL, BN_ATOL = 1e-4, 1e-5
TLOSS = tgluon.loss.SoftmaxCrossEntropyLoss()
JLOSS = jgluon.loss.SoftmaxCrossEntropyLoss()


def _jbuild(seed=0, bn=False, hybrid=False):
    """The reference's ``_build``: an MLP (optionally with BatchNorm),
    Xavier after ``mx.random.seed(seed)``, deferred shapes resolved."""
    jmx.random.seed(seed)
    net = jgluon.nn.HybridSequential(prefix=f"cs{seed}_")
    with net.name_scope():
        if bn:
            net.add(jgluon.nn.Dense(16), jgluon.nn.BatchNorm(),
                    jgluon.nn.Activation("relu"), jgluon.nn.Dense(4))
        else:
            net.add(jgluon.nn.Dense(16, activation="relu"),
                    jgluon.nn.Dense(4))
    net.initialize(init=jmx.initializer.Xavier())
    with jag.pause(train_mode=False):
        net(jnd.array(np.zeros((1, 6), np.float32)))
    if hybrid:
        net.hybridize()
    return net


def _tbuild(seed=0, bn=False, hybrid=False):
    """The port's net of the same structure and prefix, holding the JAX
    net's initial weights."""
    jnet = _jbuild(seed, bn)
    arrays = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    net = tgluon.nn.HybridSequential(prefix=f"cs{seed}_")
    with net.name_scope():
        if bn:
            net.add(tgluon.nn.Dense(16), tgluon.nn.BatchNorm(),
                    tgluon.nn.Activation("relu"), tgluon.nn.Dense(4))
        else:
            net.add(tgluon.nn.Dense(16, activation="relu"),
                    tgluon.nn.Dense(4))
    net.initialize(device="cpu")
    with tag.pause(train_mode=False):
        net(torch.zeros(1, 6))
    load_gluon_params(net, arrays)
    if hybrid:
        net.hybridize()
    return net


def _data(steps=5, n=32):
    rng = np.random.RandomState(7)
    X = rng.randn(steps, n, 6).astype(np.float32)
    Y = (np.arange(steps * n).reshape(steps, n) % 4).astype(np.float32)
    return X, Y


def _t(a):
    return tnd.array(a, ctx="cpu")


def _np(v):
    """A loss value of either package as numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().numpy().copy()
    return v.asnumpy().copy()


def _t_eager(net, opt, opt_args, sizes, lrs=None, params=None):
    tr = tgluon.Trainer(params or net.collect_params(), opt, dict(opt_args))
    X, Y = _data(len(sizes))
    losses = []
    for s, n in enumerate(sizes):
        if lrs:
            tr.set_learning_rate(lrs[s % len(lrs)])
        with tag.record():
            loss = TLOSS(net(_t(X[s][:n])), _t(Y[s][:n]))
        tag.backward(loss)
        tr.step(n)
        losses.append(_np(loss))
    return tr, losses


def _t_compiled(net, opt, opt_args, sizes, lrs=None, params=None, **kw):
    tr = tgluon.Trainer(params or net.collect_params(), opt, dict(opt_args))
    step = tr.compile_step(lambda x, y: TLOSS(net(x), y), **kw)
    X, Y = _data(len(sizes))
    losses = []
    for s, n in enumerate(sizes):
        if lrs:
            tr.set_learning_rate(lrs[s % len(lrs)])
        losses.append(_np(step(_t(X[s][:n]), _t(Y[s][:n]))))
    return tr, step, losses


def _j_compiled(net, opt, opt_args, sizes, lrs=None, params=None, **kw):
    tr = jgluon.Trainer(params or net.collect_params(), opt, dict(opt_args))
    step = tr.compile_step(lambda x, y: JLOSS(net(x), y), **kw)
    X, Y = _data(len(sizes))
    losses = []
    for s, n in enumerate(sizes):
        if lrs:
            tr.set_learning_rate(lrs[s % len(lrs)])
        losses.append(step(jnd.array(X[s][:n]), jnd.array(Y[s][:n]))
                      .asnumpy())
    return tr, step, losses


def _tparams(net):
    return {k: p.data().detach().numpy().copy()
            for k, p in sorted(net.collect_params().items())}


def _jparams(net):
    return {k: p.data().asnumpy()
            for k, p in sorted(net.collect_params().items())}


def _bitexact(a, b):
    pa, pb = _tparams(a), _tparams(b)
    assert list(pa) == list(pb)
    for k in pa:
        assert (pa[k] == pb[k]).all(), f"parameter {k} differs"


def _close_to_jax(tnet, jnet, rtol=RTOL, atol=ATOL):
    """The port's weights against the JAX net's, by position (names
    match after the root prefix)."""
    tp, jp = list(_tparams(tnet).values()), list(_jparams(jnet).values())
    assert len(tp) == len(jp)
    for i, (a, b) in enumerate(zip(tp, jp)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"parameter #{i}")


def _losses_close(tl, jl, rtol=RTOL, atol=ATOL):
    for s, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"step {s}")


@pytest.mark.parametrize("opt,args", [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"learning_rate": 1e-3, "wd": 1e-3}),
])
def test_parity_bitexact(opt, args):
    """5 steps across lr and batch-size changes: losses, weights,
    optimizer states and update counts bit for bit with the port's eager
    path; losses and weights against the JAX compiled step."""
    sizes = [32, 16, 32, 16, 32]
    lrs = [0.05, 0.02, 0.05, 0.01]
    net_e = _tbuild()
    tr_e, el = _t_eager(net_e, opt, args, sizes, lrs)
    net_c = _tbuild()
    tr_c, step, cl = _t_compiled(net_c, opt, args, sizes, lrs)
    assert step.last_reason is None, step.last_reason
    for s in range(len(sizes)):
        assert (el[s] == cl[s]).all(), f"step {s} loss not bit-exact"
    _bitexact(net_e, net_c)
    oe, oc = tr_e._optimizer, tr_c._optimizer
    assert oe._index_update_count == oc._index_update_count
    assert oe.num_update == oc.num_update
    sa, sb = tr_e._updaters[0].states, tr_c._updaters[0].states
    assert sorted(sa) == sorted(sb)
    for k in sa:
        la = sa[k] if isinstance(sa[k], tuple) else (sa[k],)
        lb = sb[k] if isinstance(sb[k], tuple) else (sb[k],)
        for x, y in zip(la, lb):
            assert (x == y).all(), f"optimizer state {k} differs"
    jnet = _jbuild()
    _, jstep, jl = _j_compiled(jnet, opt, args, sizes, lrs)
    assert jstep.last_reason is None
    _losses_close(cl, jl)
    _close_to_jax(net_c, jnet)


def test_parity_hybridized():
    """A hybridized block runs its eager forward inside the step (its
    CachedOp is bypassed) and stays bit for bit with hybridized eager
    training; the JAX compiled step over its hybridized net agrees."""
    sizes = [32] * 5
    net_e = _tbuild(hybrid=True)
    _, el = _t_eager(net_e, "sgd", {"learning_rate": 0.05}, sizes)
    net_c = _tbuild(hybrid=True)
    _, step, cl = _t_compiled(net_c, "sgd", {"learning_rate": 0.05}, sizes)
    assert step.last_reason is None
    for s in range(5):
        assert (el[s] == cl[s]).all()
    _bitexact(net_e, net_c)
    # the block's own CachedOp saw the eager calls only
    assert net_c._cached_op is None or net_c._cached_op.signatures <= 1
    jnet = _jbuild(hybrid=True)
    _, _, jl = _j_compiled(jnet, "sgd", {"learning_rate": 0.05}, sizes)
    _losses_close(cl, jl)
    _close_to_jax(net_c, jnet)


def test_zero_recompile_lr_and_tails():
    """After one build per bucket, lr changes and ragged tails mapped to
    warm buckets build nothing (on the card: capture nothing); one
    program per bucket; an unseen tail size pads to a warm bucket. The
    JAX step keeps the same two programs and the same losses."""
    reg = get_registry()
    builds = reg.counter("mxtpu_train_step_bucket_compiles_total",
                         labelnames=("bucket",))
    seq = [(0, 32), (1, 20), (2, 7)] + [
        (s, n) for s, n in enumerate([32, 20, 32, 7, 20, 32], start=3)]
    losses = {}
    for pkg in ("port", "jax"):
        net = _tbuild() if pkg == "port" else _jbuild()
        if pkg == "port":
            tr = tgluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-3})
            step = tr.compile_step(lambda x, y, net=net: TLOSS(net(x), y))
            arr = _t
        else:
            tr = jgluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-3})
            step = tr.compile_step(lambda x, y, net=net: JLOSS(net(x), y))
            arr = jnd.array
        X, Y = _data(10)
        out = []
        for i, (s, n) in enumerate(seq):
            if i == 3 and pkg == "port":
                b0 = sum(c.value for c in builds.children())
            if s >= 3:
                tr.set_learning_rate(1e-3 * (s + 1))
            out.append(_np(step(arr(X[s][:n]), arr(Y[s][:n]))))
        assert step.last_reason is None
        assert step.cache_size() == 2        # one program per bucket
        if pkg == "port":
            assert sum(c.value for c in builds.children()) == b0, \
                "an lr change or a warm batch tail built a new program"
            step(arr(X[9][:19]), arr(Y[9][:19]))   # 19 -> warm bucket 32
            assert step.cache_size() == 2
            assert sum(c.value for c in builds.children()) == b0
        losses[pkg] = out
    _losses_close(losses["port"], losses["jax"])


def test_bucket_tail_semantics():
    """A padded tail's per-sample losses equal the unpadded eager step's
    bitwise; the update agrees to the reference's tolerance (the port's
    CPU step keeps the bits); the pad rows are counted. The JAX step's
    padded tail agrees."""
    net_e = _tbuild()
    _, el = _t_eager(net_e, "sgd", {"learning_rate": 0.05}, [32, 20])
    reg = get_registry()
    padded = reg.counter("mxtpu_train_step_padded_rows_total")
    p0 = padded.value
    net_c = _tbuild()
    _, step, cl = _t_compiled(net_c, "sgd", {"learning_rate": 0.05},
                              [32, 20])
    assert cl[1].shape == (20,)
    assert (el[1] == cl[1]).all(), "tail losses not bit-exact"
    for (ka, a), (kb, b) in zip(_tparams(net_e).items(),
                                _tparams(net_c).items()):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=ka)
    assert padded.value - p0 == 12
    jnet = _jbuild()
    _, _, jl = _j_compiled(jnet, "sgd", {"learning_rate": 0.05}, [32, 20])
    _losses_close(cl, jl)
    _close_to_jax(net_c, jnet)


def test_amp_scaled_parity_and_overflow_skip():
    """A float16 loss scaler's rescale is a scalar of the step's row
    (scaled runs stay bit for bit with eager AMP); a forced overflow
    skips the update: weights unchanged, the scale halves, no step tick.
    The JAX step agrees on both."""
    sizes = [16] * 4
    X, Y = _data(len(sizes), 16)

    def amp_eager(net):
        tr = tgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": .05})
        tamp.init_trainer(tr, loss_scaler=tamp.LossScaler(
            init_scale=64.0, target_dtype="float16"))
        for s, n in enumerate(sizes):
            with tag.record():
                loss = TLOSS(net(_t(X[s][:n])), _t(Y[s][:n]))
                with tamp.scale_loss(loss, tr) as scaled:
                    pass
            tag.backward(scaled)
            tr.step(n)

    net_e = _tbuild(3)
    amp_eager(net_e)
    net_c = _tbuild(3)
    tr_c = tgluon.Trainer(net_c.collect_params(), "sgd",
                          {"learning_rate": .05})
    tamp.init_trainer(tr_c, loss_scaler=tamp.LossScaler(
        init_scale=64.0, target_dtype="float16"))
    step = tr_c.compile_step(lambda x, y: TLOSS(net_c(x), y))
    for s, n in enumerate(sizes):
        step(_t(X[s][:n]), _t(Y[s][:n]))
    assert step.last_reason is None
    _bitexact(net_e, net_c)
    assert tr_c._amp_loss_scaler.loss_scale == 64.0
    jnet = _jbuild(3)
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd",
                         {"learning_rate": .05})
    jmx.amp.init_trainer(jtr, loss_scaler=jmx.amp.LossScaler(
        init_scale=64.0, target_dtype="float16"))
    jstep = jtr.compile_step(lambda x, y: JLOSS(jnet(x), y))
    for s, n in enumerate(sizes):
        jstep(jnd.array(X[s][:n]), jnd.array(Y[s][:n]))
    _close_to_jax(net_c, jnet)

    # overflow: a scale beyond float32's range makes every gradient
    # non-finite; the update must not run
    for pkg in ("port", "jax"):
        if pkg == "port":
            net = _tbuild(4)
            tr = tgluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": .05})
            tamp.init_trainer(tr, loss_scaler=tamp.LossScaler(
                init_scale=1e39, target_dtype="float16"))
            st = tr.compile_step(lambda x, y, net=net: TLOSS(net(x), y))
            before, arr, params = _tparams(net), _t, _tparams
        else:
            net = _jbuild(4)
            tr = jgluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": .05})
            jmx.amp.init_trainer(tr, loss_scaler=jmx.amp.LossScaler(
                init_scale=1e39, target_dtype="float16"))
            st = tr.compile_step(lambda x, y, net=net: JLOSS(net(x), y))
            before, arr, params = _jparams(net), jnd.array, _jparams
        with pytest.warns(UserWarning, match="overflow"):
            st(arr(X[0]), arr(Y[0]))
        assert tr._amp_loss_scaler.loss_scale == 5e38
        assert tr._step_count == 0
        assert st.last_reason is None
        after = params(net)
        for k, v in before.items():
            assert (after[k] == v).all(), f"{pkg}: {k} changed on overflow"


def test_bn_aux_states_update_in_program():
    """BatchNorm's running statistics update inside the step: bit for
    bit with the port's eager training, against the JAX step to
    BN_RTOL; they move."""
    sizes = [32] * 4
    net_e = _tbuild(bn=True)
    _, el = _t_eager(net_e, "sgd", {"learning_rate": 0.05}, sizes)
    net_c = _tbuild(bn=True)
    _, step, cl = _t_compiled(net_c, "sgd", {"learning_rate": 0.05}, sizes)
    assert step.last_reason is None
    for s in range(4):
        assert (el[s] == cl[s]).all()
    _bitexact(net_e, net_c)
    moved = [k for k, v in _tparams(net_c).items()
             if "running_mean" in k and v.any()]
    assert moved, "running statistics never updated under the step"
    jnet = _jbuild(bn=True)
    _, _, jl = _j_compiled(jnet, "sgd", {"learning_rate": 0.05}, sizes)
    _losses_close(cl, jl, BN_RTOL, BN_ATOL)
    _close_to_jax(net_c, jnet, BN_RTOL, BN_ATOL)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_stays_correct(remat):
    """remat='dots'/'full' recomputes the forward in the backward without
    changing the trained result (bit for bit with eager on the CPU; the
    recompute writes no running statistics); the JAX step's remat
    agrees."""
    sizes = [32] * 3
    for bn in (False, True):
        net_e = _tbuild(5, bn=bn)
        _, el = _t_eager(net_e, "sgd", {"learning_rate": 0.05}, sizes)
        net_c = _tbuild(5, bn=bn)
        _, step, cl = _t_compiled(net_c, "sgd", {"learning_rate": 0.05},
                                  sizes, remat=remat)
        assert step.last_reason is None
        for s in range(3):
            assert (el[s] == cl[s]).all()
        _bitexact(net_e, net_c)
    jnet = _jbuild(5)
    _, _, jl = _j_compiled(jnet, "sgd", {"learning_rate": 0.05}, sizes,
                           remat=remat)
    net_c = _tbuild(5)
    _, _, cl = _t_compiled(net_c, "sgd", {"learning_rate": 0.05}, sizes,
                           remat=remat)
    _losses_close(cl, jl)
    _close_to_jax(net_c, jnet)


def test_checkpoint_resume_midrun():
    """save_state after 3 compiled steps, then restore into a fresh net
    and trainer: the resumed steps are bit for bit the uninterrupted
    run's (optimizer states, Adam's counts, the RNG position and the
    bucket warmth ride the checkpoint). The JAX run's weights agree."""
    X, Y = _data(5)
    with tempfile.TemporaryDirectory() as run_dir:
        net_a = _tbuild(6)
        tr_a = tgluon.Trainer(net_a.collect_params(), "adam",
                              {"learning_rate": 1e-3})
        step_a = tr_a.compile_step(lambda x, y: TLOSS(net_a(x), y))
        for s in range(3):
            step_a(_t(X[s]), _t(Y[s]))
        manifest_path = tr_a.save_state(run_dir)
        for s in range(3, 5):
            step_a(_t(X[s]), _t(Y[s]))
        final_a = list(_tparams(net_a).values())

        net_b = _tbuild(7)          # other weights: restore overwrites
        tr_b = tgluon.Trainer(net_b.collect_params(), "adam",
                              {"learning_rate": 1e-3})
        manifest = tr_b.restore_state(run_dir)
        assert manifest["extra"]["compiled_step"] == {"max_batch": 32}
        step_b = tr_b.compile_step(lambda x, y: TLOSS(net_b(x), y))
        assert step_b._max_batch == 32
        for s in range(3, 5):
            step_b(_t(X[s]), _t(Y[s]))
        assert tr_b._step_count == 5
        for i, (a, b) in enumerate(zip(final_a, _tparams(net_b).values())):
            assert (a == b).all(), f"param #{i} diverged after resume"
        del manifest_path
    jnet = _jbuild(6)
    jtr = jgluon.Trainer(jnet.collect_params(), "adam",
                         {"learning_rate": 1e-3})
    jstep = jtr.compile_step(lambda x, y: JLOSS(jnet(x), y))
    for s in range(5):
        jstep(jnd.array(X[s]), jnd.array(Y[s]))
    _close_to_jax(net_b, jnet)


def test_fallback_reasons_and_parity():
    """Ineligible configurations run the eager path (the same numbers),
    counted by the reference's labels, the same in both packages; a host
    read inside loss_fn is a sticky trace_failed, and training goes on."""
    reg = get_registry()
    fallback = reg.counter("mxtpu_train_step_fallback_total",
                           labelnames=("reason",))
    X, Y = _data(2)
    mp = {"learning_rate": 1e-3, "multi_precision": True}

    # an optimizer outside the fused set -> 'optimizer'
    net = _tbuild(8)
    tr = tgluon.Trainer(net.collect_params(), "adam", dict(mp))
    step = tr.compile_step(lambda x, y: TLOSS(net(x), y))
    before = fallback.labels(reason="optimizer").value
    step(_t(X[0]), _t(Y[0]))
    assert fallback.labels(reason="optimizer").value == before + 1
    assert step.last_reason == "optimizer"
    jnet = _jbuild(8)
    jtr = jgluon.Trainer(jnet.collect_params(), "adam", dict(mp))
    jstep = jtr.compile_step(lambda x, y: JLOSS(jnet(x), y))
    jstep(jnd.array(X[0]), jnd.array(Y[0]))
    assert jstep.last_reason == step.last_reason
    _close_to_jax(net, jnet)

    # the env kill switch -> 'env_disabled', the eager numbers
    os.environ["MXNET_TPU_COMPILED_STEP"] = "0"
    try:
        net_e = _tbuild(9)
        _, el = _t_eager(net_e, "sgd", {"learning_rate": .05}, [32, 32])
        net_c = _tbuild(9)
        _, stepc, cl = _t_compiled(net_c, "sgd", {"learning_rate": .05},
                                   [32, 32])
        assert stepc.last_reason == "env_disabled"
        for s in range(2):
            assert (el[s] == cl[s]).all()
        _bitexact(net_e, net_c)
        jnet = _jbuild(9)
        _, jstepc, _ = _j_compiled(jnet, "sgd", {"learning_rate": .05},
                                   [32, 32])
        assert jstepc.last_reason == "env_disabled"
    finally:
        del os.environ["MXNET_TPU_COMPILED_STEP"]

    # a host read inside loss_fn -> trace_failed, sticky; the eager
    # path trains
    net_d = _tbuild(10)
    tr_d = tgluon.Trainer(net_d.collect_params(), "sgd",
                          {"learning_rate": .05})

    def branchy_loss(x, y):
        out = net_d(x)
        if float(tnd.sum(out).asscalar()) > 1e9:     # a host sync
            out = out * 2
        return TLOSS(out, y)

    step_d = tr_d.compile_step(branchy_loss)
    w0 = _tparams(net_d)
    with pytest.warns(UserWarning, match="trace failed"):
        step_d(_t(X[0]), _t(Y[0]))
    assert step_d.last_reason == "trace_failed"
    step_d(_t(X[1]), _t(Y[1]))
    assert step_d.last_reason == "trace_failed"
    assert any((_tparams(net_d)[k] != v).any() for k, v in w0.items()), \
        "the fallback did not train"
    jnet_d = _jbuild(10)
    jtr_d = jgluon.Trainer(jnet_d.collect_params(), "sgd",
                           {"learning_rate": .05})

    def jbranchy(x, y):
        out = jnet_d(x)
        if float(out.asnumpy().sum()) > 1e9:
            out = out * 2
        return JLOSS(out, y)
    jstep_d = jtr_d.compile_step(jbranchy)
    with pytest.warns(UserWarning, match="trace failed"):
        jstep_d(jnd.array(X[0]), jnd.array(Y[0]))
    jstep_d(jnd.array(X[1]), jnd.array(Y[1]))
    assert jstep_d.last_reason == step_d.last_reason
    _close_to_jax(net_d, jnet_d)


def test_frozen_subset_trainer_promotes_untracked_params():
    """Fine-tuning half the parameters: the frozen half is read by
    address, so changing one in place is seen by the next compiled step;
    the trained half stays bit for bit with eager, and with the JAX
    step to tolerance."""
    X, Y = _data(3)

    def head(net):
        return {k: p for k, p in net.collect_params().items()
                if "dense1" in k}

    net_e = _tbuild(11)
    tr_e = tgluon.Trainer(head(net_e), "sgd", {"learning_rate": 0.05})
    el = []
    for s in range(3):
        with tag.record():
            loss = TLOSS(net_e(_t(X[s])), _t(Y[s]))
        tag.backward(loss)
        tr_e.step(32)
        el.append(_np(loss))
    net_c = _tbuild(11)
    tr_c = tgluon.Trainer(head(net_c), "sgd", {"learning_rate": 0.05})
    step = tr_c.compile_step(lambda x, y: TLOSS(net_c(x), y))
    cl = []
    for s in range(3):
        cl.append(_np(step(_t(X[s]), _t(Y[s]))))
        assert (el[s] == cl[s]).all()
    assert step.last_reason is None
    _bitexact(net_e, net_c)
    jnet = _jbuild(11)
    jtr = jgluon.Trainer(head(jnet), "sgd", {"learning_rate": 0.05})
    jstep = jtr.compile_step(lambda x, y: JLOSS(jnet(x), y))
    jl = [jstep(jnd.array(X[s]), jnd.array(Y[s])).asnumpy()
          for s in range(3)]
    _losses_close(cl, jl)

    # change a frozen parameter in place: the next step must see it
    for net in (net_c, net_e):
        for k, p in net.collect_params().items():
            if "dense0_weight" in k:
                p.set_data(p.data().detach() * 0.0)
    lc = _np(step(_t(X[0]), _t(Y[0])))
    with tag.record():
        le = TLOSS(net_e(_t(X[0])), _t(Y[0]))
    tag.backward(le)
    tr_e.step(32)
    assert (_np(le) == lc).all(), "the step served a stale frozen weight"
    for k, p in jnet.collect_params().items():
        if "dense0_weight" in k:
            p.set_data(p.data() * 0.0)
    jl0 = jstep(jnd.array(X[0]), jnd.array(Y[0])).asnumpy()
    np.testing.assert_allclose(lc, jl0, rtol=RTOL, atol=ATOL)
    _close_to_jax(net_c, jnet)


def test_mesh_not_ported_and_jit_resolves():
    """``mx.jit`` resolves in the port; the reference's SPMD arguments
    raise, naming the ROADMAP item."""
    assert tmx.jit.CompiledTrainStep is not None
    net = _tbuild(12)
    tr = tgluon.Trainer(net.collect_params(), "sgd", {"learning_rate": .1})
    with pytest.raises(NotImplementedError, match="item 9"):
        tr.compile_step(lambda x, y: TLOSS(net(x), y), mesh="dp=2")
    with pytest.raises(ValueError):
        tr.compile_step(lambda x, y: TLOSS(net(x), y), remat="some")

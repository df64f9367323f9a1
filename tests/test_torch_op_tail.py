"""PyTorch port, the rest of the op registry: the four aliases and every
op of the tail of ``mxnet_tpu_torch/ops/extra.py`` (the output layers
with their own backward, the spatial, index, shape, contrib, image and
``_npx_``/``_npi_`` ops) against the JAX package's op of the same name on
the same numpy inputs, forward and, where the op is differentiable, its
VJP (``jax.vjp`` against ``torch.autograd.grad`` on the same seeded
cotangent); and the total coverage of the registry.

The cases are chip_smoke.py's ``TAIL_CORPUS`` (the ones phase 7c runs on
the card) and the JAX suite's own cases of these ops
(tests/test_numeric_gradient.py, tests/test_grad_sweep_registry.py).
This file runs every third case of the op tail (the rest:
tests/test_torch_op_tail2.py, tests/test_torch_op_tail3.py);
:func:`run_tail_case` also runs the detection, quantization and RNN
cases (tests/test_torch_detection.py, tests/test_torch_detection2.py,
tests/test_torch_detection2b.py, tests/test_torch_detection2c.py,
tests/test_torch_quantization.py and tests/test_torch_rnn.py load this
file by path; tests/test_torch_detection_suite.py and
tests/test_torch_detection2_suite.py run the JAX suite's detection tests
on both packages).

Tolerances (f32, ``chip_smoke.corpus_tol`` by the case's family): exact
for shape, index, integer and host ops; rtol 1e-5 / atol 1e-6 for
elementwise; rtol 1e-4 / atol 1e-5 for products, resampling and every
VJP; a case that needs more is in ``chip_smoke.WIDER_TOL`` with its
reason.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import mxnet_tpu  # noqa: E402,F401  (registers the JAX ops)
from mxnet_tpu.ops import registry as jreg  # noqa: E402
from mxnet_tpu_torch import _rng, nd  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "_tail_" + name, os.path.join(HERE, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CORPUS = _load("test_torch_op_corpus")

# the names the port leaves out, each with the ROADMAP item it waits for
NOT_PORTED = {
    "Custom": "item 14 (operator.py)",
}
# the LAMB and AdaGrad update tail, held here case by case
# (chip_smoke.CORPUS's "update" family, which phase 7b runs on the card)
UPDATE_TAIL = [(c[0], c[1], c[2], c[3]) for c in chip_smoke.CORPUS
               if c[3] == "update"]
# the file holding each module's cases
_FILES = {"contrib_det": "detection", "contrib_det2": "detection2",
          "quantization": "quantization", "rnn": "rnn"}
# held by their statistics here, not case by case
DRAWS = ("_npi_uniform_n", "_npi_normal_n")


def file_of(name):
    """The test file (suffix) whose cases hold op ``name``."""
    mod = treg.get(name).impl.__module__.rsplit(".", 1)[-1]
    return _FILES.get(mod, "op_tail")


FAMILY = {}
for _c in chip_smoke.TAIL_CORPUS:
    FAMILY.setdefault(_c[0], _c[3])


def _suite_cases():
    """The JAX suite's cases of the ops of the tail corpus."""
    out = []
    for op, inputs, kwargs in _CORPUS._TNG.ALL_CASES:
        out.append((op, inputs, dict(kwargs)))
    for _, (op, inputs, kwargs, grad_inputs, *_r) in sorted(
            _CORPUS._SWEEP.T.items()):
        kw = dict(kwargs)
        if grad_inputs is not None:
            kw["_grad_inputs"] = tuple(grad_inputs)
        out.append((op, inputs, kw))
    kept = []
    for op, inputs, kw in out:
        if not isinstance(op, str) or op not in FAMILY:
            continue
        if "_numeric_grad_inputs" in kw:
            kw["_grad_inputs"] = kw.pop("_numeric_grad_inputs")
        kw.pop("_numeric_tol", None)
        kept.append((op, inputs, kw, FAMILY[op]))
    return kept


CASES = [c for c in chip_smoke.TAIL_CORPUS if c[0] not in DRAWS] + \
    _suite_cases()


def cases_for(which, part=(0, 1)):
    """The cases (and ids) of test file ``which``; ``part=(k, n)`` keeps
    every n-th of them from the k-th on (cases split across files)."""
    picked = [(i, c) for i, c in enumerate(CASES) if file_of(c[0]) == which]
    picked = picked[part[0]::part[1]]
    return [c for _, c in picked], [f"{c[0]}-{i}" for i, c in picked]


def _outs(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _dtype_name(x):
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.dtype(x.dtype).name


def _call(impl, op, xs, kw):
    out = impl(list(xs), **kw) if op.variadic else impl(*xs, **kw)
    return tuple(out) if isinstance(out, (tuple, list)) else out


def run_tail_case(name, inputs, kwargs, family):
    """One case: the port's op against the JAX op, forward outputs (shape,
    dtype, values) and, for a differentiable op, the VJP."""
    kw = {k: v for k, v in kwargs.items() if not k.startswith("_")}
    grad_inputs = kwargs.get("_grad_inputs")
    arrays = chip_smoke.tail_arrays(inputs, kwargs)
    jop, top = jreg.get(name), treg.get(name)
    tkw, jkw = dict(kw), dict(kw)
    jkw.pop("ctx", None)
    if top.needs_rng:
        tkw["rng"] = jkw["rng"] = None
    if top.needs_train:
        tkw["_training"] = jkw["_training"] = False
    diff = top.differentiable and jop.differentiable
    jx = [jnp.asarray(a) for a in arrays]
    tx = [torch.from_numpy(a.copy()) for a in arrays]
    if grad_inputs is None:
        grad_inputs = tuple(i for i, a in enumerate(arrays)
                            if a.dtype == np.float32)
    if diff and grad_inputs:
        for i in grad_inputs:
            tx[i].requires_grad_(True)
        want, vjp = jax.vjp(lambda *xs: _call(jop.impl, jop, xs, jkw), *jx)
    else:
        want = _call(jop.impl, jop, jx, jkw)
    got = _call(top.impl, top, tx, tkw)
    want_t, got_t = _outs(want), _outs(got)
    assert len(got_t) == len(want_t), name
    rtol, atol = chip_smoke.corpus_tol(top, family, True)
    for k, (g, w) in enumerate(zip(got_t, want_t)):
        assert tuple(g.shape) == tuple(np.shape(w)), (name, k)
        assert _dtype_name(g) == _dtype_name(jnp.asarray(w)), (name, k)
        np.testing.assert_allclose(
            g.detach().numpy().astype(np.float64),
            np.asarray(w).astype(np.float64), rtol=rtol, atol=atol,
            err_msg=f"{name} output {k}")
    if not diff or not grad_inputs:
        return
    rs = np.random.RandomState(7)
    cots = [np.asarray(rs.randn(*np.shape(w)), np.asarray(w).dtype)
            if jnp.issubdtype(np.asarray(w).dtype, jnp.floating) else None
            for w in want_t]
    jcots = tuple(jnp.asarray(c) if c is not None else
                  np.zeros(np.shape(w), jax.dtypes.float0)
                  for c, w in zip(cots, want_t))
    jgrads = vjp(jcots if isinstance(want, (tuple, list)) else jcots[0])
    pairs = [(g, torch.from_numpy(c)) for g, c in zip(got_t, cots)
             if c is not None and g.requires_grad]
    if not pairs:
        return
    tgrads = torch.autograd.grad([p[0] for p in pairs],
                                 [tx[i] for i in grad_inputs],
                                 [p[1] for p in pairs], allow_unused=True)
    rtol, atol = chip_smoke.corpus_tol(top, family, False)
    for i, tg in zip(grad_inputs, tgrads):
        want_g = np.asarray(jgrads[i])
        got_g = np.zeros_like(want_g) if tg is None else tg.numpy()
        np.testing.assert_allclose(got_g, want_g, rtol=rtol, atol=atol,
                                   err_msg=f"{name} VJP input {i}")


_HERE_CASES, _HERE_IDS = cases_for("op_tail", part=(0, 3))


@pytest.mark.parametrize("name,inputs,kwargs,family", _HERE_CASES,
                         ids=_HERE_IDS)
def test_op_matches_jax(name, inputs, kwargs, family):
    run_tail_case(name, inputs, kwargs, family)


@pytest.mark.parametrize("name,inputs,kwargs,family", UPDATE_TAIL,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(UPDATE_TAIL)])
def test_update_tail_matches_jax(name, inputs, kwargs, family):
    """The LAMB phases (f32 and mp), the multi-tensor LAMB and the two
    AdaGrads: the port's op against the JAX op, every output (the
    tolerance: ``chip_smoke.WIDER_TOL``'s); the reference's ``nout``,
    ``mutates`` and variadic form, never differentiated."""
    run_tail_case(name, inputs, kwargs, family)
    top, jop = treg.get(name), jreg.get(name)
    assert (top.nout, top.mutates, top.variadic) == \
        (jop.nout, jop.mutates, jop.variadic)
    assert not top.differentiable


def test_the_registry_is_covered():
    """Every name of the JAX registry is registered in the port but the
    one of :data:`NOT_PORTED`; every name the port registers has a
    parity case, is held in another file (the op corpus's ``ELSEWHERE``)
    or is an alias of a name that has one."""
    missing = sorted(set(jreg._REGISTRY) - set(treg._REGISTRY))
    assert missing == sorted(NOT_PORTED), missing
    cased = {c[0] for c in _CORPUS.CASES} | {c[0] for c in CASES} | \
        set(DRAWS) | {c[0] for c in UPDATE_TAIL}
    held = cased | set(_CORPUS.ELSEWHERE)
    by_op = {}
    for n in cased:
        by_op.setdefault(id(treg.get(n)), n)
    bare = [n for n in treg.list_ops() if n not in held
            and id(treg.get(n)) not in by_op
            and not n.startswith(("_nd_test_", "_rtc_"))]
    assert not bare, bare


def test_new_names_reach_nd_and_contrib():
    """The aliases and the contrib ops are reachable as a user reaches
    them: ``nd.MakeLoss``, ``nd.contrib.box_nms``,
    ``nd.contrib.quantize_v2``."""
    x = nd.array(np.arange(6.0).reshape(2, 3), ctx="cpu")
    assert np.array_equal(nd.MakeLoss(x).asnumpy(), x.asnumpy())
    for short in ("box_nms", "ROIAlign", "quantize_v2", "quantized_matmul",
                  "MultiBoxPrior", "fft", "boolean_mask"):
        assert callable(getattr(nd.contrib, short)), short
    with pytest.raises(AttributeError):
        nd.contrib.no_such_op


@pytest.mark.parametrize("name", DRAWS)
def test_samplers_by_their_moments(name):
    """``_npi_uniform_n`` / ``_npi_normal_n``: 2^16 draws within 4
    standard errors of the distribution's mean and variance; one
    ``(seed, position)`` gives one stream, another seed another (JAX's
    threefry bits are not reproduced)."""
    kw = ({"low": -1.0, "high": 3.0} if name == "_npi_uniform_n"
          else {"loc": 0.5, "scale": 2.0})
    mean, var = ((1.0, 16.0 / 12) if name == "_npi_uniform_n"
                 else (0.5, 4.0))
    fn = getattr(nd, name)
    _rng.seed(5)
    a = fn(size=(1 << 16,), ctx="cpu", **kw).asnumpy()
    _rng.seed(5)
    b = fn(size=(1 << 16,), ctx="cpu", **kw).asnumpy()
    _rng.seed(6)
    c = fn(size=(1 << 16,), ctx="cpu", **kw).asnumpy()
    n = a.size
    assert a.dtype == np.float32
    assert abs(a.mean() - mean) < 4 * np.sqrt(var / n)
    assert abs(a.var() - var) < 4 * var * np.sqrt(2.0 / n)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    # the JAX op draws the same distribution
    j = np.asarray(jreg.get(name).impl(rng=jax.random.PRNGKey(0),
                                       size=(1 << 16,), **kw))
    assert abs(j.mean() - mean) < 4 * np.sqrt(var / n)


def test_output_layers_ignore_the_head_gradient():
    """The regression outputs' gradient is ``(pred - label) *
    grad_scale`` whatever head gradient arrives, as the JAX ops'."""
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    lab = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    head = np.full((3, 4), 7.0, np.float32)
    for name in ("LinearRegressionOutput", "LogisticRegressionOutput",
                 "MAERegressionOutput"):
        t = torch.from_numpy(x.copy()).requires_grad_(True)
        out = treg.get(name).impl(t, torch.from_numpy(lab), grad_scale=0.25)
        (g,) = torch.autograd.grad(out, t, torch.from_numpy(head))
        _, vjp = jax.vjp(lambda d: jreg.get(name).impl(
            d, jnp.asarray(lab), grad_scale=0.25), jnp.asarray(x))
        np.testing.assert_allclose(g.numpy(), np.asarray(
            vjp(jnp.asarray(head))[0]), rtol=1e-5, atol=1e-6)


def test_constraint_check_raises():
    with pytest.raises(ValueError, match="bad"):
        nd._npx_constraint_check(nd.array(np.array([1.0, 0.0]), ctx="cpu"),
                                 msg="bad")


def test_share_memory_sees_one_buffer():
    x = nd.array(np.arange(4.0), ctx="cpu")
    assert bool(nd._npi_share_memory(x, x).asnumpy())
    assert not bool(nd._npi_share_memory(x, x.copy()).asnumpy())


def test_image_resize_weights_are_jax_scale_and_translate():
    """``_image_resize``'s linear weights against ``jax.image.resize`` on
    a downsample, an upsample and a mixed case within 1e-5, and an
    integer image truncated as ``astype`` truncates."""
    img = np.random.RandomState(3).uniform(0, 255, (9, 14, 2)).astype(
        np.float32)
    for size in ((5, 3), (20, 17), (7, 13)):
        got = treg.get("_image_resize").impl(torch.from_numpy(img),
                                             size=size).numpy()
        want = np.asarray(jax.image.resize(jnp.asarray(img),
                                           (size[1], size[0], 2),
                                           method="linear"))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    imgi = np.floor(img).astype(np.int32)
    got = treg.get("_image_resize").impl(torch.from_numpy(imgi),
                                         size=(5, 3)).numpy()
    want = np.asarray(jreg.get("_image_resize").impl(jnp.asarray(imgi),
                                                     size=(5, 3)))
    assert got.dtype == np.int32 and np.array_equal(got, want)

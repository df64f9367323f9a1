"""PyTorch port, the op corpus: every op of the elementwise, reduction,
shape, linalg and nn families (``mxnet_tpu_torch/ops/{elemwise,reduce,
shape_ops,linalg,nn}.py``) against the JAX package's op of the same name
on the same numpy inputs, forward and, where the op is differentiable,
its VJP (``jax.vjp`` against ``torch.autograd.grad`` on the same seeded
cotangent). This file runs the elementwise, reduction and shape cases
and the coverage tests; tests/test_torch_op_corpus_nn.py and
tests/test_torch_op_corpus_nn2.py run the nn cases (alternately),
tests/test_torch_op_corpus_linalg.py the rest (linalg and the ops
outside the JAX family modules: attention, LoRA, the internal
elementwise names), each loading this file's cases by path.

The cases are the JAX suite's own: ``ALL_CASES`` of
tests/test_numeric_gradient.py and the templates of
tests/test_grad_sweep_registry.py (loaded by path), each kept where the
port registers its op, plus chip_smoke.py's ``CORPUS`` (:data:`CORPUS`),
the cases phase 7b runs on the card: every op of the families, and the
options the JAX lists leave out.

Tolerances (f32): exact for the shape family and for every
non-differentiable op (comparisons, indices, counts); rtol 1e-5 / atol
1e-6 for the elementwise and reduction families; rtol 1e-4 / atol 1e-5
for linalg, nn (products, normalizations) and every VJP. A case that
needs more is in chip_smoke.py's ``WIDER_TOL`` with its reason (the
tolerances are ``chip_smoke.corpus_tol``'s). The random ops are held
in tests/test_torch_random.py, the update ops in
tests/test_torch_optimizer.py and tests/test_torch_multi_update.py
(:data:`ELSEWHERE`).
"""
import importlib.util
import os
import sys
import types

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
from mxnet_tpu_torch import nd  # noqa: E402,F401  (registers the port's)
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "_corpus_" + name, os.path.join(HERE, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_TNG = _load("test_numeric_gradient")
_SWEEP = _load("test_grad_sweep_registry")


# the corpus of chip_smoke.py's phase 7b (JAX-free, so the card runs it):
# the same seeded inputs, held here against the JAX ops
CORPUS = [(name, inputs, kwargs) for name, inputs, kwargs, _ in
          chip_smoke.CORPUS]

# ops held elsewhere, with where
ELSEWHERE = {}
for _n in treg.list_ops():
    _o = treg.get(_n)
    if _o.needs_rng and _n not in ("LeakyReLU",):
        ELSEWHERE[_n] = "random draws: tests/test_torch_random.py"
    elif _o.mutates:
        ELSEWHERE[_n] = "update op: tests/test_torch_optimizer.py, " \
            "tests/test_torch_multi_update.py"
for _n in ("multi_sgd_update", "multi_sgd_mom_update", "multi_mp_sgd_update",
           "multi_mp_sgd_mom_update", "preloaded_multi_sgd_update",
           "preloaded_multi_sgd_mom_update", "preloaded_multi_mp_sgd_update",
           "preloaded_multi_mp_sgd_mom_update", "_multi_adamw_update",
           "_multi_mp_adamw_update", "all_finite", "multi_all_finite",
           "multi_sum_sq", "multi_lars", "reset_arrays"):
    ELSEWHERE[_n] = "update tail: tests/test_torch_multi_update.py"
# the LAMB and AdaGrad update tail: chip_smoke.CORPUS's "update" cases
for _c in chip_smoke.CORPUS:
    if _c[3] == "update":
        ELSEWHERE[_c[0]] = "update tail: tests/test_torch_op_tail.py"
ELSEWHERE["ragged_paged_attention"] = "tests/test_torch_nd.py, " \
    "tests/test_torch_ragged_paged.py"
# the op tail, detection, quantization and RNN ops (chip_smoke.py's
# TAIL_CORPUS) and the tail's two samplers
for _n in [c[0] for c in chip_smoke.TAIL_CORPUS] + ["_npi_uniform_n",
                                                    "_npi_normal_n"]:
    ELSEWHERE[_n] = "tests/test_torch_op_tail.py and the files it " \
        "names (detection, quantization, RNN)"

_FAMILIES = ("elemwise", "reduce", "shape_ops", "linalg", "random_ops", "nn")
MODULE14 = (
    "all_finite", "multi_all_finite", "multi_sum_sq", "reset_arrays",
    "mp_nag_mom_update", "_mp_adamw_update", "multi_sgd_update",
    "multi_sgd_mom_update", "multi_mp_sgd_update", "multi_mp_sgd_mom_update",
    "multi_lars", "preloaded_multi_sgd_update",
    "preloaded_multi_sgd_mom_update", "preloaded_multi_mp_sgd_update",
    "preloaded_multi_mp_sgd_mom_update", "_multi_adamw_update",
    "_multi_mp_adamw_update", "ftml_update")


def _jax_families():
    """{family: op names} of the JAX package's family modules, each
    loaded by path into a fresh registry (the package's registry holds
    them all together)."""
    import mxnet_tpu.base
    pkg = types.ModuleType("_corpus_fam")
    pkg.__path__ = []
    ops = types.ModuleType("_corpus_fam.ops")
    ops.__path__ = []
    saved = {k: sys.modules.get(k) for k in
             ("_corpus_fam", "_corpus_fam.base", "_corpus_fam.ops")}
    sys.modules.update({"_corpus_fam": pkg, "_corpus_fam.ops": ops,
                        "_corpus_fam.base": mxnet_tpu.base})
    src = os.path.join(os.path.dirname(HERE), "mxnet_tpu", "ops")

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"_corpus_fam.ops.{name}", os.path.join(src, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        return mod
    try:
        reg = load("registry")
        out = {}
        for fam in _FAMILIES:
            before = set(reg._REGISTRY)
            load(fam)
            out[fam] = set(reg._REGISTRY) - before
        return out
    finally:
        for k in list(sys.modules):
            if k.startswith("_corpus_fam"):
                del sys.modules[k]
        for k, v in saved.items():
            if v is not None:
                sys.modules[k] = v


FAMILY_OF = {}
for _fam, _names in _jax_families().items():
    for _n in _names:
        FAMILY_OF[_n] = _fam


def _cases():
    out = []
    for op, inputs, kwargs in _TNG.ALL_CASES:
        kw = dict(kwargs)
        if "_numeric_grad_inputs" in kw:
            kw["_grad_inputs"] = kw.pop("_numeric_grad_inputs")
        kw.pop("_numeric_tol", None)
        out.append((op, inputs, kw))
    for name, (op, inputs, kwargs, grad_inputs, *_rest) in sorted(
            _SWEEP.T.items()):
        kw = dict(kwargs)
        if grad_inputs is not None:
            kw["_grad_inputs"] = tuple(grad_inputs)
        out.append((name, inputs, kw))
    out += CORPUS
    kept, seen = [], set()
    for c in out:
        if c[0] not in treg._REGISTRY or c[0] in ELSEWHERE:
            continue
        # an alias's case of the same op on the same inputs runs once
        key = (id(treg.get(c[0])), repr(sorted(c[2].items())),
               tuple(np.asarray(a).tobytes() for a in c[1]))
        if key not in seen:
            seen.add(key)
            kept.append(c)
    return kept


CASES = _cases()


def _tol(name, fwd):
    return chip_smoke.corpus_tol(treg.get(name), FAMILY_OF.get(name), fwd)


def _dtype_name(x):
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.dtype(x.dtype).name


def _outs(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _sign_fix(v):
    """Eigenvectors (columns) with their largest component positive."""
    v = np.asarray(v)
    idx = np.argmax(np.abs(v), axis=-2)
    s = np.sign(np.take_along_axis(v, idx[..., None, :], axis=-2))
    return v * s


def _call(impl, op, xs, kw):
    out = impl(list(xs), **kw) if op.variadic else impl(*xs, **kw)
    # a named tuple (jnp.linalg.eigh's) as a plain one, for jax.vjp
    return tuple(out) if isinstance(out, (tuple, list)) else out


def cases_of(families, part=(0, 1)):
    """The cases whose op belongs to one of ``families`` (None: an op of
    no JAX family module), with their ids; ``part=(k, n)`` keeps every
    n-th of them from the k-th on (a family split across files)."""
    picked = [(i, c) for i, c in enumerate(CASES)
              if FAMILY_OF.get(c[0]) in families]
    picked = picked[part[0]::part[1]]
    return [c for _, c in picked], [f"{c[0]}-{i}" for i, c in picked]


def run_case(name, inputs, kwargs):
    """One case: forward outputs (shape, dtype, values) and, for a
    differentiable op, the VJP, the port's op against the JAX op's."""
    kw = dict(kwargs)
    grad_inputs = kw.pop("_grad_inputs", None)
    int_input = kw.pop("_int_input", False)
    lengths_as_params = kw.pop("_lengths_as_params", False)
    arrays = [np.asarray(a, np.int32 if int_input else np.float32)
              for a in inputs]
    tkw, jkw = dict(kw), dict(kw)
    for k in ("length",):
        if k in kw:
            tkw[k] = torch.from_numpy(np.asarray(kw[k], np.float32))
            jkw[k] = jnp.asarray(np.asarray(kw[k], np.float32))
    if lengths_as_params:
        # CTC's lengths ride the params, as the JAX op takes them
        tkw["data_lengths"], tkw["label_lengths"] = (
            torch.from_numpy(a) for a in arrays[2:4])
        jkw["data_lengths"], jkw["label_lengths"] = arrays[2:4]
        arrays = arrays[:2]
    jkw.pop("ctx", None)
    jop, top = jreg.get(name), treg.get(name)
    for k in ("rng",):
        if top.needs_rng:
            tkw[k] = None
            jkw[k] = None
    if top.needs_train:
        tkw.setdefault("_training", False)
        jkw.setdefault("_training", tkw["_training"])
    diff = top.differentiable and jop.differentiable
    jx = [jnp.asarray(a) for a in arrays]
    tx = [torch.from_numpy(a.copy()) for a in arrays]
    if grad_inputs is None:
        grad_inputs = tuple(i for i, a in enumerate(arrays)
                            if a.dtype == np.float32)
    if diff:
        for i in grad_inputs:
            tx[i].requires_grad_(True)
        want, vjp = jax.vjp(lambda *xs: _call(jop.impl, jop, xs, jkw), *jx)
    else:
        want = _call(jop.impl, jop, jx, jkw)
    got = _call(top.impl, top, tx, tkw)
    want_t, got_t = _outs(want), _outs(got)
    assert len(got_t) == len(want_t), name
    rtol, atol = _tol(name, True)
    for k, (g, w) in enumerate(zip(got_t, want_t)):
        assert tuple(g.shape) == tuple(w.shape), (name, k)
        assert _dtype_name(g) == _dtype_name(w), (name, k)
        gv = g.detach().numpy()
        wv = np.asarray(w)
        if name == "_linalg_syevd" and k == 1:
            gv, wv = _sign_fix(gv), _sign_fix(wv)
        np.testing.assert_allclose(gv, wv, rtol=rtol, atol=atol,
                                   err_msg=f"{name} output {k}")
    if not diff or not grad_inputs:
        return
    rs = np.random.RandomState(7)
    cots = [np.asarray(rs.randn(*w.shape), w.dtype)
            if jnp.issubdtype(w.dtype, jnp.floating) else None
            for w in want_t]
    if name == "_linalg_syevd":
        cots[1] = np.zeros_like(cots[1])    # eigenvectors' sign is free
    jcots = tuple(jnp.asarray(c) if c is not None else
                  np.zeros(w.shape, jax.dtypes.float0)
                  for c, w in zip(cots, want_t))
    jgrads = vjp(jcots if isinstance(want, (tuple, list)) else jcots[0])
    pairs = [(g, torch.from_numpy(c)) for g, c in zip(got_t, cots)
             if c is not None and g.requires_grad]
    if not pairs:
        return
    tgrads = torch.autograd.grad([p[0] for p in pairs],
                                 [tx[i] for i in grad_inputs],
                                 [p[1] for p in pairs], allow_unused=True)
    rtol, atol = _tol(name, False)
    for i, tg in zip(grad_inputs, tgrads):
        want_g = np.asarray(jgrads[i])
        got_g = np.zeros_like(want_g) if tg is None else tg.numpy()
        np.testing.assert_allclose(got_g, want_g, rtol=rtol, atol=atol,
                                   err_msg=f"{name} VJP input {i}")


_HERE_CASES, _HERE_IDS = cases_of(("elemwise", "reduce", "shape_ops"))


@pytest.mark.parametrize("name,inputs,kwargs", _HERE_CASES, ids=_HERE_IDS)
def test_op_matches_jax(name, inputs, kwargs):
    run_case(name, inputs, kwargs)


def test_families_and_update_tail_are_registered():
    """Every op the JAX package's six families and the update tail hold
    is registered in the port under its name."""
    want = set(FAMILY_OF) | set(MODULE14)
    missing = sorted(n for n in want if n not in treg._REGISTRY)
    assert not missing, missing


def test_every_port_op_has_a_parity_case():
    """Every op the port registers (an alias group counts once) has a
    case here or is held in another file (:data:`ELSEWHERE`)."""
    covered = {c[0] for c in CASES} | set(ELSEWHERE)
    groups = {}
    for n in treg.list_ops():
        groups.setdefault(id(treg.get(n)), []).append(n)
    missing = [sorted(g) for g in groups.values()
               if not set(g) & covered and not any(
                   n.startswith("_nd_test_") or n.startswith("_rtc_")
                   for n in g)]
    assert not missing, missing

"""PyTorch port, ``mx.metric`` (``mxnet_tpu_torch/metric.py``) against the
JAX package's ``mxnet_tpu/metric.py``.

- every case of ``tests/test_metric.py`` runs on the port: the module is
  loaded by path and its ``M`` (the metric module) and ``_nd`` (the array
  maker) are pointed at the port's, CPU tensors through ``nd.array``;
- the zoo on random inputs from a seed: the same numpy batches go to the
  JAX metrics as ``nd.array``s and to the port's as ``torch`` tensors
  (float32, and bfloat16 against the JAX side fed the bf16-rounded
  values), two updates with a ``reset_local`` between; ``get()`` and
  ``get_global()`` must agree, instance counts exactly and values to
  1e-12 relative (the arithmetic is the same numpy code on the same
  values).
"""
import importlib.util
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch  # noqa: E402

from mxnet_tpu import metric as jm, nd as jnd  # noqa: E402
from mxnet_tpu_torch import metric as tm, nd as tnd  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-12


def _load_reference_tests():
    spec = importlib.util.spec_from_file_location(
        "reference_test_metric_under_torch",
        os.path.join(REPO, "tests", "test_metric.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference_tests()
REF_CASES = sorted(n for n in dir(REF) if n.startswith("test_"))


@pytest.mark.parametrize("case", REF_CASES)
def test_reference_case_on_the_port(case, monkeypatch):
    monkeypatch.setattr(REF, "M", tm)
    monkeypatch.setattr(
        REF, "_nd", lambda a: tnd.array(np.asarray(a, np.float32),
                                        ctx="cpu"))
    getattr(REF, case)()


def _voc(rs, n=2, g=3, a=6):
    lab = -np.ones((n, g, 6), np.float32)
    det = -np.ones((n, a, 6), np.float32)
    for b in range(n):
        for k in range(g - 1):
            x, y = rs.uniform(0, 50, 2)
            lab[b, k] = [rs.randint(3), x, y, x + rs.uniform(5, 30),
                         y + rs.uniform(5, 30), float(k == 0 and b == 1)]
        for k in range(a - 1):
            src = lab[b, rs.randint(g - 1)]
            jit = rs.uniform(-4, 4, 4)
            det[b, k] = [src[0] if k % 3 else rs.randint(3),
                         rs.uniform(), *(src[1:5] + jit)]
    return lab, det


def _classes(rs, n=12, c=5):
    return (rs.randint(c, size=n).astype(np.float32),
            rs.uniform(size=(n, c)).astype(np.float32))


def _probs(rs, n=12, c=5):
    lab = rs.randint(c, size=n).astype(np.float32)
    p = rs.uniform(0.05, 1, size=(n, c)).astype(np.float32)
    return lab, (p / p.sum(1, keepdims=True)).astype(np.float32)


def _regress(rs, n=12):
    lab = rs.randn(n, 3).astype(np.float32)
    return lab, (lab + 0.3 * rs.randn(n, 3)).astype(np.float32)


def _loss(rs, n=12):
    return None, rs.uniform(0, 3, size=n).astype(np.float32)


# (name, constructor kwargs, batch maker)
ZOO = [
    ("Accuracy", {}, _classes),
    ("TopKAccuracy", {"top_k": 3}, _classes),
    ("Perplexity", {"ignore_label": None}, _probs),
    ("CrossEntropy", {}, _probs),
    ("NegativeLogLikelihood", {}, _probs),
    ("MAE", {}, _regress),
    ("MSE", {}, _regress),
    ("RMSE", {}, _regress),
    ("PearsonCorrelation", {}, _regress),
    ("PearsonCorrelation", {"average": "micro"}, _regress),
    ("Loss", {}, _loss),
    ("VOCMApMetric", {}, _voc),
    ("VOC07MApMetric", {}, _voc),
]


def _bf16(a):
    """``a`` rounded to bfloat16 (as float32), and the bf16 tensor."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    return t.float().numpy(), t


def _feed(metric, batches, as_array):
    out = []
    for k, (lab, pred) in enumerate(batches):
        if k:
            metric.reset_local()
        labels = [] if lab is None else [as_array(lab)]
        preds = [as_array(pred)]
        metric.update(labels if lab is not None else 0, preds)
        out.append((metric.num_inst, metric.get(), metric.get_global()))
    return out


def _same(t, j):
    assert len(t) == len(j)
    for (tn, tget, tglob), (jn, jget, jglob) in zip(t, j):
        assert tn == jn
        for (a_name, a), (b_name, b) in ((tget, jget), (tglob, jglob)):
            assert a_name == b_name
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0,
                                       equal_nan=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw,make", ZOO,
                         ids=[f"{n}{'-' + '-'.join(map(str, k.values())) if k else ''}"
                              for n, k, _ in ZOO])
def test_zoo_matches_the_reference_on_random_inputs(name, kw, make, dtype):
    rs = np.random.RandomState(sum(map(ord, name)) + len(kw))
    batches = [make(rs), make(rs)]
    if dtype == "bfloat16":
        rounded, tensors = [], []
        for lab, pred in batches:
            pr, pt = _bf16(pred)
            rounded.append((lab, pr))
            tensors.append((lab, pt))
        jbatches = rounded
        tfeed = [(lab, pt) for lab, pt in tensors]
    else:
        jbatches = batches
        tfeed = [(lab, torch.from_numpy(pred)) for lab, pred in batches]

    def t_array(a):
        return a if isinstance(a, torch.Tensor) else torch.from_numpy(a)

    j = _feed(getattr(jm, name)(**kw), jbatches, jnd.array)
    t = _feed(getattr(tm, name)(**kw), tfeed, t_array)
    _same(t, j)


def test_ndarray_numpy_and_tensor_inputs_agree():
    rs = np.random.RandomState(5)
    lab, pred = _classes(rs)
    vals = []
    for make in (lambda a: a, torch.from_numpy,
                 lambda a: tnd.array(a, ctx="cpu")):
        m = tm.CompositeEvalMetric([tm.Accuracy(), tm.TopKAccuracy(2)])
        m.update([make(lab)], [make(pred)])
        vals.append(m.get())
    assert vals[0] == vals[1] == vals[2]
    j = jm.CompositeEvalMetric([jm.Accuracy(), jm.TopKAccuracy(2)])
    j.update([jnd.array(lab)], [jnd.array(pred)])
    assert vals[0] == j.get()

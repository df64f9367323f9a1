"""PyTorch port, all fifteen of gluon's losses against the JAX package's
(``mxnet_tpu/gluon/loss.py``) on the same numpy inputs: the loss and the
gradient of every float input, for the cases of ``tests/test_gluon.py``'s
``test_losses``, the CTC cases of ``tests/test_rnn.py`` and
``tests/test_ctc_torch_oracle.py`` (blank last, label and data lengths,
both layouts), weights, ``sample_weight`` and the options of each loss.

Tolerance: ``LOSS_TOL = 2e-5`` of each result's magnitude (f32 sums and
transcendentals in torch's order against XLA's; CTC's forward-backward
recursion in torch's CPU kernel against the JAX scan).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import loss as jloss

from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.gluon import loss as tloss

torch.set_num_threads(2)

LOSS_TOL = 2e-5


def _softmax(a):
    e = np.exp(a - a.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _inputs(seed):
    rs = np.random.RandomState(seed)
    pred = rs.randn(8, 4).astype(np.float32)
    dense = np.abs(rs.randn(8, 4)).astype(np.float32)
    sign = np.sign(rs.randn(8, 4)).astype(np.float32)
    sparse = rs.randint(0, 4, (8,)).astype(np.float32)
    sw = rs.uniform(0.5, 1.5, (8, 1)).astype(np.float32)
    return pred, dense, sign, sparse, sw


def _ctc(seed, layout, label_layout, lengths):
    rs = np.random.RandomState(seed)
    T, B, A, L = 12, 4, 11, 4
    logits = rs.randn(T, B, A).astype(np.float32)
    lab_len = rs.randint(1, L + 1, size=B).astype(np.float32)
    labels = rs.randint(0, A - 1, size=(B, L)).astype(np.float32)
    for b in range(B):
        labels[b, int(lab_len[b]):] = -1
    dat_len = np.array([12, 10, 9, 12], np.float32)
    if layout == "NTC":
        logits = logits.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        labels = labels.T.copy()
    args = [logits, labels]
    if lengths:
        args += [dat_len, lab_len]
    return args


def _cases():
    pred, dense, sign, sparse, sw = _inputs(0)
    logp = np.log(_softmax(pred)).astype(np.float32)
    rs = np.random.RandomState(5)
    rate = rs.uniform(0.5, 3.0, (8, 4)).astype(np.float32)
    counts = rs.poisson(2.0, (8, 4)).astype(np.float32)
    x1 = rs.randn(6, 5).astype(np.float32)
    x2 = (x1 + 0.3 * rs.randn(6, 5)).astype(np.float32)
    cos_lab = np.array([1, -1, 1, 1, -1, -1], np.float32)
    # (id, class, kwargs, inputs, indices of the inputs without gradient)
    return [
        ("l2", "L2Loss", {}, [pred, dense], ()),
        ("l2_weight_sw", "L2Loss", dict(weight=0.7), [pred, dense, sw], (2,)),
        ("l1", "L1Loss", {}, [pred, dense], ()),
        ("l1_batch_axis1", "L1Loss", dict(batch_axis=1), [pred, dense], ()),
        ("softmax_ce_sparse", "SoftmaxCrossEntropyLoss", {},
         [pred, sparse], (1,)),
        ("softmax_ce_dense", "SoftmaxCrossEntropyLoss",
         dict(sparse_label=False), [pred, _softmax(dense)], ()),
        ("softmax_ce_from_logits", "SoftmaxCrossEntropyLoss",
         dict(from_logits=True, weight=2.0), [logp, sparse, sw], (1, 2)),
        ("sigmoid_bce", "SigmoidBinaryCrossEntropyLoss", {},
         [pred, (sign + 1) / 2], ()),
        ("sigmoid_bce_pos_weight", "SigmoidBinaryCrossEntropyLoss", {},
         [pred, (sign + 1) / 2, None, dense + 0.5], ()),
        ("sigmoid_bce_from_sigmoid", "SigmoidBCELoss",
         dict(from_sigmoid=True), [1 / (1 + np.exp(-pred)),
                                   (sign + 1) / 2], ()),
        ("sigmoid_bce_from_sigmoid_pos_weight",
         "SigmoidBinaryCrossEntropyLoss", dict(from_sigmoid=True),
         [1 / (1 + np.exp(-pred)), (sign + 1) / 2, sw, dense + 0.5], ()),
        ("kl_div", "KLDivLoss", {}, [logp, _softmax(dense)], ()),
        ("kl_div_logits", "KLDivLoss", dict(from_logits=False, axis=-1),
         [pred, _softmax(dense)], ()),
        ("huber", "HuberLoss", {}, [pred, dense], ()),
        ("huber_rho", "HuberLoss", dict(rho=0.3, weight=1.5),
         [pred, dense, sw], (2,)),
        ("hinge", "HingeLoss", {}, [pred, sign], ()),
        ("hinge_margin", "HingeLoss", dict(margin=0.5), [pred, sign], ()),
        ("squared_hinge", "SquaredHingeLoss", {}, [pred, sign], ()),
        ("logistic_signed", "LogisticLoss", {},
         [pred[:, 0].copy(), sign[:, 0].copy()], ()),
        ("logistic_binary", "LogisticLoss", dict(label_format="binary"),
         [pred, (sign + 1) / 2], ()),
        ("poisson_nll", "PoissonNLLLoss", {}, [pred, dense], ()),
        ("poisson_nll_rates_full", "PoissonNLLLoss",
         dict(from_logits=False, compute_full=True), [rate, counts], ()),
        ("triplet", "TripletLoss", {}, [pred, dense, dense + 1], ()),
        ("triplet_margin", "TripletLoss", dict(margin=3.0),
         [pred, dense, dense - 0.5, sw[:, 0].copy()], (3,)),
        ("cosine_embedding", "CosineEmbeddingLoss", {},
         [x1, x2, cos_lab], (2,)),
        ("cosine_embedding_margin", "CosineEmbeddingLoss",
         dict(margin=0.2), [x1, x2, cos_lab], (2,)),
        ("sdml", "SDMLLoss", {}, [x1, x2], ()),
        ("sdml_smoothing", "SDMLLoss", dict(smoothing_parameter=0.1),
         [x1, x2], ()),
        ("ctc_ntc", "CTCLoss", {}, _ctc(0, "NTC", "NT", False), (1,)),
        ("ctc_ntc_lengths", "CTCLoss", {}, _ctc(1, "NTC", "NT", True),
         (1, 2, 3)),
        ("ctc_tnc_tn_lengths", "CTCLoss",
         dict(layout="TNC", label_layout="TN"), _ctc(2, "TNC", "TN", True),
         (1, 2, 3)),
        ("ctc_tnc_weight", "CTCLoss", dict(layout="TNC", weight=0.5),
         _ctc(3, "TNC", "NT", False), (1,)),
    ]


CASES = _cases()


def _rel_close(got, want, what):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= LOSS_TOL * max(np.abs(want).max(), 1.0), (what, err)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_loss_and_gradients_match_jax(case):
    name, cls, kw, arrays, no_grad = CASES[case]
    jl = getattr(jloss, cls)(**kw)
    jl.hybridize()
    tl = getattr(tloss, cls)(prefix="loss_", **kw)
    jargs, targs, grads = [], [], []
    for i, a in enumerate(arrays):
        if a is None:
            jargs.append(None)
            targs.append(None)
            continue
        j = jmx.nd.array(a)
        t = torch.from_numpy(a.copy())
        if i not in no_grad:
            j.attach_grad()
            t.requires_grad_()
            grads.append((i, j, t))
        jargs.append(j)
        targs.append(t)
    with jag.record():
        jy = jl(*jargs)
    with tag.record():
        ty = tl(*targs)
    assert tuple(ty.shape) == tuple(jy.shape), name
    _rel_close(ty.detach().numpy(), jy.asnumpy(), f"{name} loss")
    head = np.random.RandomState(9).uniform(
        0.5, 1.5, jy.shape).astype(np.float32)
    jy.backward(jmx.nd.array(head))
    ty.backward(torch.from_numpy(head))
    for i, j, t in grads:
        _rel_close(t.grad.numpy(), j.grad.asnumpy(), f"{name} grad {i}")
    assert repr(tl) == repr(jl)


def test_the_fifteen_losses_are_all_there():
    assert sorted(n for n in jloss.__all__ if n.endswith("Loss")) == \
        sorted(n for n in tloss.__all__ if n.endswith("Loss"))
    covered = {c[1] for c in CASES}
    assert covered >= {n for n in tloss.__all__ if n.endswith("Loss")
                       and n not in ("Loss", "SigmoidBCELoss",
                                     "SoftmaxCELoss")}
    with pytest.raises(ValueError):
        tloss.LogisticLoss(label_format="probability")
    with pytest.raises(ValueError):
        tloss.CTCLoss(layout="CTN")

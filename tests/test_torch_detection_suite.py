"""PyTorch port, the SSD/R-CNN detection ops against the JAX package's:
the op tests of tests/test_detection.py, each run on both packages on
the same numpy inputs with the outputs held equal (anchors, targets,
masks, kept rows) or within the product tolerance (ROIAlign: rtol 1e-4,
atol 1e-5), and the ties: equal scores, ``-inf`` rows, a label of -1
rows only, a box ROIAlign clips. The SSD-300 model tests of
tests/test_detection.py and its VOC mAP metric wait with the gluon model
zoo (ROADMAP.md, item 13).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.registry import _REGISTRY as JREG
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.ops.registry import _REGISTRY as TREG

torch.set_num_threads(2)
PROD = dict(rtol=1e-4, atol=1e-5)
# rois decoded through exp: the two libraries' exp can move an edge by an
# ulp (the batch index column stays exact)
ELEMWISE = dict(rtol=1e-5, atol=1e-6)


def both(name, *args, exact=True, **kw):
    """The port's op and the JAX op on the same numpy inputs; their
    outputs held equal (``exact=True``), within the product tolerance
    (``False``) or within the tolerance ``exact`` gives. Returns the
    port's outputs as numpy."""
    got = TREG[name].impl(*[torch.from_numpy(np.asarray(a)) for a in args],
                          **kw)
    want = JREG[name].impl(*[jnp.asarray(a) for a in args], **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    outs = []
    for g, w in zip(got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if exact is True:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, err_msg=name,
                                       **(exact or PROD))
        outs.append(g)
    return outs[0] if len(outs) == 1 else tuple(outs)


# ------------------------------------------------ tests/test_detection.py --
def test_multibox_prior_matches_reference_math():
    x = np.zeros((1, 3, 2, 3), np.float32)
    a = both("_contrib_MultiBoxPrior", x, sizes=(0.5, 0.3), ratios=(1.0, 2.0))
    h, w = 2, 3
    assert a.shape == (1, h * w * 3, 4)
    cy, cx = 0.5 / h, 0.5 / w
    w0, h0 = 0.5 * (h / w) / 2, 0.5 / 2
    np.testing.assert_allclose(a[0, 0], [cx - w0, cy - h0, cx + w0,
                                         cy + h0], rtol=1e-5)
    w2, h2 = 0.5 * (h / w) * np.sqrt(2) / 2, 0.5 / np.sqrt(2) / 2
    np.testing.assert_allclose(a[0, 2], [cx - w2, cy - h2, cx + w2,
                                         cy + h2], rtol=1e-5)
    c = both("_contrib_MultiBoxPrior", x, sizes=(0.9,), clip=True)
    assert c.min() >= 0 and c.max() <= 1


def test_box_iou():
    a = np.array([[0, 0, 2, 2], [1, 1, 3, 3]], np.float32)
    b = np.array([[0, 0, 2, 2], [2, 2, 4, 4]], np.float32)
    iou = both("_contrib_box_iou", a, b)
    np.testing.assert_allclose(iou, [[1.0, 0.0], [1 / 7, 1 / 7]], rtol=1e-5)


def _toy_setup():
    anchors = np.asarray(JREG["_contrib_MultiBoxPrior"].impl(
        jnp.zeros((1, 3, 4, 4)), sizes=(0.4,), ratios=(1.0, 2.0)))
    A = anchors.shape[1]
    label = np.full((2, 3, 6), -1.0, np.float32)
    label[0, 0] = [1, 0.1, 0.1, 0.4, 0.4, 0]
    label[0, 1] = [0, 0.6, 0.6, 0.9, 0.95, 0]
    label[1, 0] = [2, 0.3, 0.2, 0.8, 0.7, 0]
    cls_pred = np.random.RandomState(0).randn(2, 4, A).astype(np.float32)
    return anchors, A, label, cls_pred


def test_multibox_target_assignment():
    anchors, A, label, cls_pred = _toy_setup()
    lt, lm, ct = both("_contrib_MultiBoxTarget", anchors, label, cls_pred,
                      overlap_threshold=0.5, negative_mining_ratio=3.0)
    assert lt.shape == (2, A * 4) and ct.shape == (2, A)
    assert (ct[0] > 0).sum() >= 2 and (ct[1] > 0).sum() >= 1
    npos, nneg = (ct[0] > 0).sum(), (ct[0] == 0).sum()
    assert nneg <= 3 * npos
    assert (ct[0] == -1).sum() == A - npos - nneg
    np.testing.assert_array_equal(lm[0].reshape(A, 4).any(axis=1),
                                  ct[0] > 0)


def test_multibox_target_no_mining_all_negatives():
    anchors, A, label, cls_pred = _toy_setup()
    _, _, ct = both("_contrib_MultiBoxTarget", anchors, label, cls_pred,
                    negative_mining_ratio=-1.0)
    assert ((ct == 0) | (ct > 0)).all()


def test_multibox_encode_decode_roundtrip():
    anchors, A, label, cls_pred = _toy_setup()
    lt, _, ct = both("_contrib_MultiBoxTarget", anchors, label, cls_pred,
                     overlap_threshold=0.5, negative_mining_ratio=3.0)
    probs = np.zeros((1, 4, A), np.float32)
    probs[0, 0, :] = 1.0
    for i in np.where(ct[0] > 0)[0]:
        probs[0, int(ct[0][i]), i] = 1.0
        probs[0, 0, i] = 0.0
    d = both("_contrib_MultiBoxDetection", probs, lt[0:1], anchors,
             nms_threshold=0.45, threshold=0.2)[0]
    kept = d[d[:, 0] >= 0]
    assert len(kept) >= 2
    assert (np.diff(kept[:, 1]) <= 1e-6).all()


def test_box_nms_suppresses_overlaps():
    data = np.array([[
        [0, 0.9, 0.1, 0.1, 0.5, 0.5],
        [0, 0.8, 0.12, 0.12, 0.52, 0.52],
        [0, 0.7, 0.6, 0.6, 0.9, 0.9],
        [1, 0.6, 0.11, 0.11, 0.51, 0.51],
    ]], np.float32)
    o = both("_contrib_box_nms", data, overlap_thresh=0.5, coord_start=2,
             score_index=1, id_index=0)[0]
    assert (o[:, 0] >= 0).sum() == 3
    o2 = both("_contrib_box_nms", data, overlap_thresh=0.5, coord_start=2,
              score_index=1, id_index=0, force_suppress=True)[0]
    assert (o2[:, 0] >= 0).sum() == 2


def test_roi_align_values_and_grad():
    H = W = 8
    ramp = np.arange(W, dtype=np.float32)[None, :].repeat(H, 0)
    img = np.stack([ramp, ramp.T])[None]
    rois = np.array([[0, 1, 1, 5, 5]], np.float32)
    out = both("_contrib_ROIAlign", img, rois, pooled_size=(2, 2),
               spatial_scale=1.0, sample_ratio=2, exact=False)
    np.testing.assert_allclose(out[0, 0], [[2.0, 4.0], [2.0, 4.0]],
                               atol=1e-5)
    t = torch.from_numpy(img).requires_grad_(True)
    TREG["_contrib_ROIAlign"].impl(t, torch.from_numpy(rois),
                                   pooled_size=(2, 2),
                                   sample_ratio=2).sum().backward()
    assert float(t.grad.sum()) == pytest.approx(8.0, rel=1e-5)


# ------------------------------------------------------------------ ties --
def test_equal_scores_keep_the_lower_index():
    """Equal scores everywhere: the detection and NMS rows are the JAX
    ops' bits (stable order), not ``torch.topk``'s."""
    A = 12
    anchors = np.asarray(JREG["_contrib_MultiBoxPrior"].impl(
        jnp.zeros((1, 3, 2, 2)), sizes=(0.3, 0.5), ratios=(1.0, 2.0)))
    probs = np.full((2, 3, A), 1.0 / 3, np.float32)
    loc = np.zeros((2, A * 4), np.float32)
    both("_contrib_MultiBoxDetection", probs, loc, anchors,
         nms_threshold=0.3, nms_topk=6, threshold=0.1)
    rows = np.concatenate([np.zeros((1, 6, 1)), np.full((1, 6, 1), 0.5),
                           np.tile([[0.1, 0.1, 0.4, 0.4]], (1, 6, 1))],
                          axis=-1).astype(np.float32)
    o = both("_contrib_box_nms", rows, overlap_thresh=0.5, id_index=0)
    assert (o[0, :, 0] >= 0).sum() == 1


def test_minus_inf_rows_and_a_label_of_padding_only():
    """Proposals whose boxes all fall below the minimum size score -inf:
    the rows repeat the first, as the JAX op's; a label of -1 rows only
    leaves every target at its initial value."""
    cls = np.random.RandomState(2).rand(1, 6, 3, 3).astype(np.float32)
    bbox = np.full((1, 12, 3, 3), -5.0, np.float32)
    im = np.array([[48.0, 48.0, 1.0]], np.float32)
    rois, sc = both("_contrib_Proposal", cls, bbox, im, scales=(2,),
                    ratios=(0.5, 1, 2), feature_stride=16,
                    rpn_pre_nms_top_n=20, rpn_post_nms_top_n=6,
                    rpn_min_size=16, output_score=True, exact=ELEMWISE)
    assert np.isinf(sc).all()
    anchors, A, _, cls_pred = _toy_setup()
    pad = np.full((2, 3, 6), -1.0, np.float32)
    lt, lm, ct = both("_contrib_MultiBoxTarget", anchors, pad, cls_pred,
                      negative_mining_ratio=3.0)
    assert not lt.any() and not lm.any() and (ct == -1).all()


def test_roi_align_clips_a_box_outside_the_map():
    """A roi reaching past the map: its samples clip to the edge in both
    packages; the gradient lands on the edge pixels."""
    data = np.random.RandomState(4).randn(1, 2, 6, 6).astype(np.float32)
    rois = np.array([[0, 3.0, 3.0, 11.0, 9.0], [0, -4.0, -2.0, 2.0, 1.0]],
                    np.float32)
    both("_contrib_ROIAlign", data, rois, pooled_size=(3, 3),
         sample_ratio=2, exact=False)
    t = torch.from_numpy(data).requires_grad_(True)
    out = TREG["_contrib_ROIAlign"].impl(t, torch.from_numpy(rois),
                                         pooled_size=(3, 3), sample_ratio=2)
    cot = np.random.RandomState(5).randn(*out.shape).astype(np.float32)
    (g,) = torch.autograd.grad(out, t, torch.from_numpy(cot))
    _, vjp = jax.vjp(lambda d: JREG["_contrib_ROIAlign"].impl(
        d, jnp.asarray(rois), pooled_size=(3, 3), sample_ratio=2),
        jnp.asarray(data))
    np.testing.assert_allclose(g.numpy(), np.asarray(
        vjp(jnp.asarray(cot))[0]), **PROD)


def test_nd_contrib_reaches_the_detection_ops():
    x = nd.array(np.zeros((1, 3, 2, 3), np.float32), ctx="cpu")
    a = nd.contrib.MultiBoxPrior(x, sizes=(0.5,), ratios=(1.0,))
    assert a.shape == (1, 6, 4)

"""PyTorch port, the detection op tail against the JAX package's: the
tests of tests/test_detection2.py, each run on both packages on the same
numpy inputs, the outputs held equal (class masks, the rois' batch
column), within rtol 1e-5 / atol 1e-6 (rois, through exp) or within the
product tolerance (the resampling ops: rtol 1e-4, atol 1e-5), beside the
original tests' own oracles.
"""
import jax.numpy as jnp
import numpy as np
import torch

from mxnet_tpu.ops.registry import _REGISTRY as JREG
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


# ----------------------------------------------- tests/test_detection2.py --
def test_proposal_basic():
    rng = np.random.RandomState(0)
    H = W = 8
    A = 3
    cls = rng.rand(1, 2 * A, H, W).astype(np.float32) * 0.1
    cls[0, A + 1, 3, 5] = 0.99
    bbox = np.zeros((1, 4 * A, H, W), np.float32)
    im_info = np.array([[128.0, 128.0, 1.0]], np.float32)
    rois = both("_contrib_Proposal", cls, bbox, im_info, scales=(8,),
                ratios=(0.5, 1, 2), feature_stride=16,
                rpn_pre_nms_top_n=50, rpn_post_nms_top_n=10,
                threshold=0.7, rpn_min_size=4)
    assert rois.shape == (10, 5) and (rois[:, 0] == 0).all()
    x1, y1, x2, y2 = rois[0, 1:]
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    assert abs(cx - 5 * 16) < 24 and abs(cy - 3 * 16) < 24


def test_multi_proposal_batched():
    rng = np.random.RandomState(1)
    A, H, W = 3, 4, 4
    cls = rng.rand(2, 2 * A, H, W).astype(np.float32)
    bbox = rng.randn(2, 4 * A, H, W).astype(np.float32) * 0.1
    im_info = np.array([[64.0, 64.0, 1.0]] * 2, np.float32)
    rois, scores = both("_contrib_MultiProposal", cls, bbox, im_info,
                        scales=(8,), ratios=(0.5, 1, 2), feature_stride=16,
                        rpn_pre_nms_top_n=20, rpn_post_nms_top_n=5,
                        output_score=True, exact=ELEMWISE)
    assert rois.shape == (10, 5)
    assert (rois[:5, 0] == 0).all() and (rois[5:, 0] == 1).all()
    assert np.isfinite(scores).all()


def test_psroi_pooling_uniform_plane():
    p, g, od = 2, 2, 3
    C = od * g * g
    data = np.zeros((1, C, 8, 8), np.float32)
    for c in range(C):
        data[0, c] = c
    rois = np.array([[0, 0, 0, 7, 7]], np.float32)
    out = both("_contrib_PSROIPooling", data, rois, spatial_scale=1.0,
               output_dim=od, pooled_size=p, group_size=g)
    for o in range(od):
        for i in range(p):
            for j in range(p):
                assert out[0, o, i, j] == o * g * g + (i * g // p) * g + \
                    (j * g // p)


def test_deformable_conv_zero_offsets_match_conv():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 7, 7).astype(np.float32)
    w = rng.randn(6, 4, 3, 3).astype(np.float32)
    off = np.zeros((2, 2 * 9, 7, 7), np.float32)
    out = both("_contrib_DeformableConvolution", x, off, w, kernel=(3, 3),
               pad=(1, 1), num_filter=6, no_bias=True, exact=False)
    want = torch.nn.functional.conv2d(torch.from_numpy(x),
                                      torch.from_numpy(w), padding=1)
    np.testing.assert_allclose(out, want.numpy(), rtol=1e-4, atol=1e-4)


def test_modulated_deformable_conv_mask_scales():
    rng = np.random.RandomState(3)
    x = rng.randn(1, 2, 5, 5).astype(np.float32)
    w = rng.randn(3, 2, 3, 3).astype(np.float32)
    off = np.zeros((1, 2 * 9, 5, 5), np.float32)
    ones = np.ones((1, 9, 5, 5), np.float32)
    kw = dict(kernel=(3, 3), pad=(1, 1), num_filter=3, no_bias=True,
              exact=False)
    out1 = both("_contrib_ModulatedDeformableConvolution", x, off, ones, w,
                **kw)
    out_h = both("_contrib_ModulatedDeformableConvolution", x, off,
                 ones * 0.5, w, **kw)
    np.testing.assert_allclose(out_h, out1 * 0.5, rtol=1e-4, atol=1e-5)


def test_deformable_psroi_no_trans_matches_psroi_constant():
    p, g, od = 2, 2, 2
    C = od * g * g
    data = np.zeros((1, C, 8, 8), np.float32)
    for c in range(C):
        data[0, c] = c
    rois = np.array([[0, 1, 1, 6, 6]], np.float32)
    out = both("_contrib_DeformablePSROIPooling", data, rois,
               spatial_scale=1.0, output_dim=od, group_size=g,
               pooled_size=p, no_trans=True, sample_per_part=2, exact=False)
    for o in range(od):
        for i in range(p):
            for j in range(p):
                np.testing.assert_allclose(out[0, o, i, j],
                                           o * g * g + i * g + j, atol=1e-4)


def test_rroi_align_zero_angle_matches_axis_aligned():
    data = np.tile(np.arange(8, dtype=np.float32)[None, None, None, :],
                   (1, 1, 8, 1))
    rois = np.array([[0, 3.5, 3.5, 4.0, 4.0, 0.0]], np.float32)
    out = both("_contrib_RROIAlign", data, rois, pooled_size=(2, 2),
               spatial_scale=1.0, exact=False)
    np.testing.assert_allclose(out[0, 0, :, 0], [2.5, 2.5], atol=0.01)
    np.testing.assert_allclose(out[0, 0, :, 1], [4.5, 4.5], atol=0.01)
    rois90 = np.array([[0, 3.5, 3.5, 4.0, 4.0, 90.0]], np.float32)
    out90 = both("_contrib_RROIAlign", data, rois90, pooled_size=(2, 2),
                 spatial_scale=1.0, exact=False)
    np.testing.assert_allclose(out90[0, 0, 0, :], [4.5, 4.5], atol=0.01)
    np.testing.assert_allclose(out90[0, 0, 1, :], [2.5, 2.5], atol=0.01)


def test_mrcnn_mask_target_shapes_and_onehot():
    rng = np.random.RandomState(5)
    rois = np.array([[[0, 0, 15, 15], [4, 4, 11, 11], [0, 0, 7, 7]]],
                    np.float32)
    masks = (rng.rand(1, 2, 16, 16) > 0.5).astype(np.float32)
    t, c = both("_contrib_mrcnn_mask_target", rois, masks,
                np.array([[0, 1, 0]], np.int32),
                np.array([[1, 3, 0]], np.int32), num_rois=3, num_classes=4,
                mask_size=(8, 8), exact=False)
    assert t.shape == c.shape == (1, 3, 4, 8, 8)
    assert c[0, 0, 1].all() and not c[0, 0, 2].any() and c[0, 1, 3].all()
    assert not c[0, 2].any()
    assert ((t >= 0) & (t <= 1)).all()


def test_hawkesll_oracle():
    rng = np.random.RandomState(6)
    N, T, K = 2, 5, 3
    args = (rng.rand(N, K).astype(np.float32) * 0.5 + 0.1,
            rng.rand(K).astype(np.float32) * 0.5,
            rng.rand(K).astype(np.float32) + 0.5,
            rng.rand(N, K).astype(np.float32),
            rng.rand(N, T).astype(np.float32),
            rng.randint(0, K, (N, T)).astype(np.int32),
            np.array([5, 3], np.float32), np.array([10.0, 8.0], np.float32))
    ll, st = both("_contrib_hawkesll", *args, exact=False)
    assert ll.shape == (N,) and st.shape == (N, K) and np.isfinite(ll).all()

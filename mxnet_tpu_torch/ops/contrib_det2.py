"""The detection op tail (the port of ``mxnet_tpu/ops/contrib_det2.py``):
RPN proposals (``_contrib_Proposal``, ``_contrib_MultiProposal``),
position-sensitive, deformable and rotated ROI ops
(``_contrib_PSROIPooling``, ``_contrib_DeformableConvolution``,
``_contrib_ModulatedDeformableConvolution``,
``_contrib_DeformablePSROIPooling``, ``_contrib_RROIAlign``), Mask R-CNN
targets (``_contrib_mrcnn_mask_target``) and the marked Hawkes
log-likelihood (``_contrib_hawkesll``).

As the JAX ops, every output has a fixed shape and every op runs over
the batch (and the rois) at once. The RPN's NMS is the JAX op's
sequential sweep over the pre-NMS top K (6000 in Faster R-CNN's test
settings): the (N, K, K) suppression array is computed in one pass (in
row blocks), then swept K steps on the device with no host read, so the
op can be captured. The top K is a stable descending sort, which puts
the lower index first on a tie, as ``lax.top_k`` does.

PSROIPooling's bin averages are read from a summed-area table of the
features in float64 (four reads a bin, the sum exact to f32) instead of
the JAX op's masked sum over the whole map: the same function, a
fraction of the work. The deformable convolution is the JAX op's:
each tap's bilinear samples gathered into a column matrix, then one
product with the weights, ``torch.matmul`` with TF32 off (a plain
product the JAX package leaves to XLA). Gradients, to the features,
offsets, masks, weights and bias, are torch's autograd through the
gathers.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .contrib_det import nms_keep
from .linalg import _f32_products
from .registry import _REGISTRY, Operator

__all__ = ["gen_base_anchors"]

# rows of the pre-NMS suppression array computed at a time
_SUP_ROWS = 1024


def _reg(name, fn, **kw):
    _REGISTRY[name] = Operator(name, fn, **kw)


# ----------------------------------------------------------- proposals ----
def gen_base_anchors(stride, scales, ratios):
    """The base anchors (A, 4): the box [0, 0, stride-1, stride-1] at each
    ratio, then each scale (the reference's GenerateAnchors)."""
    base = np.array([0, 0, stride - 1, stride - 1], np.float32)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    anchors = []
    for r in ratios:
        size = w * h
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                            cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
    return np.asarray(anchors, np.float32)


def _area(b):
    return (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)


def _rpn_suppression(boxes, thresh):
    """(N, K, K) bool: row i suppresses column j > i where their IoU (the
    +1 pixel convention) exceeds ``thresh``; computed ``_SUP_ROWS`` rows
    at a time."""
    n, k, _ = boxes.shape
    area = _area(boxes)
    cols = torch.arange(k, device=boxes.device)
    out = torch.empty((n, k, k), dtype=torch.bool, device=boxes.device)
    for lo in range(0, k, _SUP_ROWS):
        hi = min(k, lo + _SUP_ROWS)
        ref = boxes[:, lo:hi, None, :]
        b = boxes[:, None, :, :]
        iw = torch.clamp(torch.minimum(b[..., 2], ref[..., 2])
                         - torch.maximum(b[..., 0], ref[..., 0]) + 1,
                         min=0)
        ih = torch.clamp(torch.minimum(b[..., 3], ref[..., 3])
                         - torch.maximum(b[..., 1], ref[..., 1]) + 1,
                         min=0)
        inter = iw * ih
        iou = inter / (area[:, None, :] + area[:, lo:hi, None] - inter)
        rows = torch.arange(lo, hi, device=boxes.device)
        out[:, lo:hi] = (iou > thresh) & (cols[None, :] > rows[:, None])
    return out


def _proposals(scores, deltas, im_info, anchors, stride, pre_nms, post_nms,
               thresh, min_size, iou_loss):
    """The RPN over a batch: scores (N, A, H, W) foreground, deltas (N,
    4A, H, W), im_info (N, 3) = [h, w, scale]. Returns boxes (N, P, 4)
    and scores (N, P), P = min(post_nms, pre-NMS K)."""
    n, a, h, w = scores.shape
    dev = scores.device
    shift_x = (torch.arange(w, device=dev) * stride).to(torch.float32)
    shift_y = (torch.arange(h, device=dev) * stride).to(torch.float32)
    sx, sy = torch.meshgrid(shift_x, shift_y, indexing="xy")
    shifts = torch.stack([sx, sy, sx, sy], dim=-1)
    anc = (anchors[None, None] + shifts[:, :, None, :]).reshape(-1, 4)
    dts = deltas.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2).reshape(
        n, -1, 4)
    scr = scores.permute(0, 2, 3, 1).reshape(n, -1)
    aw = anc[:, 2] - anc[:, 0] + 1
    ah = anc[:, 3] - anc[:, 1] + 1
    cx = anc[:, 0] + 0.5 * (aw - 1)
    cy = anc[:, 1] + 0.5 * (ah - 1)
    if iou_loss:
        x1, y1, x2, y2 = (anc[:, i] + dts[..., i] for i in range(4))
    else:
        pcx = dts[..., 0] * aw + cx
        pcy = dts[..., 1] * ah + cy
        pw = torch.exp(torch.clamp(dts[..., 2], -10, 10)) * aw
        phh = torch.exp(torch.clamp(dts[..., 3], -10, 10)) * ah
        x1 = pcx - 0.5 * (pw - 1)
        y1 = pcy - 0.5 * (phh - 1)
        x2 = pcx + 0.5 * (pw - 1)
        y2 = pcy + 0.5 * (phh - 1)
    zero = torch.zeros((), dtype=x1.dtype, device=dev)
    imh, imw = im_info[:, 0:1], im_info[:, 1:2]
    x1 = torch.minimum(torch.maximum(x1, zero), imw - 1)
    y1 = torch.minimum(torch.maximum(y1, zero), imh - 1)
    x2 = torch.minimum(torch.maximum(x2, zero), imw - 1)
    y2 = torch.minimum(torch.maximum(y2, zero), imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    ms = min_size * im_info[:, 2:3]
    keep = ((x2 - x1 + 1) >= ms) & ((y2 - y1 + 1) >= ms)
    scr = torch.where(keep, scr, torch.full((), float("-inf"),
                                            dtype=scr.dtype, device=dev))
    k = min(pre_nms, scr.shape[1])
    top_scr, top_idx = torch.sort(scr, dim=1, descending=True, stable=True)
    top_scr, top_idx = top_scr[:, :k], top_idx[:, :k]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(n, k, 4))
    finite = torch.isfinite(top_scr)
    keep = nms_keep(_rpn_suppression(top_boxes, thresh), finite)
    # the kept boxes first, in score order; the rest repeat the first
    order = torch.sort((~keep).to(torch.int8), dim=1,
                       stable=True).indices[:, :post_nms]
    kept = torch.gather(keep, 1, order)
    sel_boxes = torch.gather(top_boxes, 1,
                             order[..., None].expand(-1, -1, 4))
    sel_scores = torch.gather(top_scr, 1, order)
    sel_boxes = torch.where(kept[..., None], sel_boxes, sel_boxes[:, :1])
    sel_scores = torch.where(kept, sel_scores, sel_scores[:, :1])
    return sel_boxes, sel_scores


def _rpn_args(cls_prob, scales, ratios, feature_stride):
    anchors = torch.from_numpy(gen_base_anchors(feature_stride, scales,
                                                ratios)).to(cls_prob.device)
    return anchors, anchors.shape[0]


def _proposal(cls_prob, bbox_pred, im_info, scales=(4, 8, 16, 32),
              ratios=(0.5, 1, 2), feature_stride=16,
              rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
              threshold=0.7, rpn_min_size=16, output_score=False,
              iou_loss=False):
    """The RPN's proposals of the first image: rois (P, 5) [0, x1, y1,
    x2, y2] (and their scores (P, 1) with ``output_score``)."""
    anchors, a = _rpn_args(cls_prob, scales, ratios, feature_stride)
    boxes, scores = _proposals(
        cls_prob[:1, a:], bbox_pred[:1], im_info[:1], anchors,
        feature_stride, int(rpn_pre_nms_top_n), int(rpn_post_nms_top_n),
        threshold, float(rpn_min_size), iou_loss)
    boxes, scores = boxes[0], scores[0]
    rois = torch.cat([torch.zeros((boxes.shape[0], 1), dtype=boxes.dtype,
                                  device=boxes.device), boxes], dim=1)
    if output_score:
        return rois, scores[:, None]
    return rois


def _multi_proposal(cls_prob, bbox_pred, im_info, scales=(4, 8, 16, 32),
                    ratios=(0.5, 1, 2), feature_stride=16,
                    rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
                    threshold=0.7, rpn_min_size=16, output_score=False,
                    iou_loss=False):
    """The batched Proposal: rois (N*P, 5) with the batch index in column
    0."""
    anchors, a = _rpn_args(cls_prob, scales, ratios, feature_stride)
    boxes, scores = _proposals(
        cls_prob[:, a:], bbox_pred, im_info, anchors, feature_stride,
        int(rpn_pre_nms_top_n), int(rpn_post_nms_top_n), threshold,
        float(rpn_min_size), iou_loss)
    n, p = boxes.shape[:2]
    bidx = torch.arange(n, dtype=boxes.dtype,
                        device=boxes.device).repeat_interleave(p)
    rois = torch.cat([bidx[:, None], boxes.reshape(-1, 4)], dim=1)
    if output_score:
        return rois, scores.reshape(-1, 1)
    return rois


# --------------------------------------------------------- psroi pooling --
def _psroi_pooling(data, rois, spatial_scale=1.0, output_dim=1,
                   pooled_size=7, group_size=0):
    """R-FCN's position-sensitive average pooling: bin (i, j) of output
    channel o averages channel o*g*g + gi*g + gj over the pixels of its
    bin, read from a float64 summed-area table. Returns (R, output_dim,
    p, p)."""
    g = int(group_size) if group_size else int(pooled_size)
    p = int(pooled_size)
    n, c, hh, ww = data.shape
    dev = data.device
    f32 = dict(dtype=torch.float32, device=dev)
    sat = F.pad(data.to(torch.float64).cumsum(2).cumsum(3), (1, 0, 1, 0))
    b = rois[:, 0].to(torch.int64)
    x1 = torch.round(rois[:, 1]) * spatial_scale
    y1 = torch.round(rois[:, 2]) * spatial_scale
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    # a 0-d divisor: CUDA divides by a Python number through its
    # reciprocal, which can move a bin edge across an integer
    pt = torch.tensor(float(p), **f32)
    bh, bw = (rh / pt)[:, None], (rw / pt)[:, None]
    it = torch.arange(p, **f32)

    def extent(start, size, lim):
        lo = torch.floor(start[:, None] + it * size)
        hi = torch.ceil(start[:, None] + (it + 1) * size)
        lo = torch.clamp(lo, 0, lim).to(torch.int64)
        hi = torch.clamp(hi, 0, lim).to(torch.int64)
        return lo, torch.maximum(hi, lo)
    ylo, yhi = extent(y1, bh, hh)                          # (R, p)
    xlo, xhi = extent(x1, bw, ww)
    gi = torch.div(torch.arange(p, device=dev) * g, p, rounding_mode="floor")
    cidx = (torch.arange(output_dim, device=dev)[:, None, None] * g * g
            + gi[None, :, None] * g + gi[None, None, :])   # (od, p, p)
    bb = b[:, None, None, None]
    cc = cidx[None]
    y0, y1_ = ylo[:, None, :, None], yhi[:, None, :, None]
    x0, x1_ = xlo[:, None, None, :], xhi[:, None, None, :]
    s = sat[bb, cc, y1_, x1_] - sat[bb, cc, y0, x1_] - \
        sat[bb, cc, y1_, x0] + sat[bb, cc, y0, x0]
    cnt = torch.clamp((y1_ - y0) * (x1_ - x0), min=1).to(torch.float64)
    return (s / cnt).to(data.dtype)


# ----------------------------------------------------- deformable convs ---
def _bilinear_nchw(img, y, x):
    """The JAX op's bilinear sampler (zero outside, the DCN convention):
    ``img`` (B, C, H, W), ``y``/``x`` (B, P) float -> (B, C, P)."""
    bsz, c, h, w = img.shape
    flat = img.reshape(bsz, c, h * w)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = y - y0
    wx = x - x0
    out = 0.0
    for dy, wgt_y in ((0, 1 - wy), (1, wy)):
        for dx, wgt_x in ((0, 1 - wx), (1, wx)):
            yy = y0 + dy
            xx = x0 + dx
            inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            yi = torch.clamp(yy, 0, h - 1).to(torch.int64)
            xi = torch.clamp(xx, 0, w - 1).to(torch.int64)
            idx = (yi * w + xi)[:, None, :].expand(bsz, c, -1)
            val = torch.gather(flat, 2, idx)
            out = out + (wgt_y * wgt_x * inside.to(img.dtype))[:, None] * val
    return out


def _deformable_conv_core(data, offset, weight, bias, mask, kernel, stride,
                          pad, dilate, num_deformable_group, num_group):
    kh, kw = kernel
    sh, sw = stride
    ph, pw = pad
    dh, dw = dilate
    n, c, h, w = data.shape
    o = weight.shape[0]
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dg = num_deformable_group
    cg = c // dg
    taps = kh * kw
    kw_ = dict(dtype=data.dtype, device=data.device)
    oy = torch.arange(ho, **kw_) * sh - ph
    ox = torch.arange(wo, **kw_) * sw - pw
    off = offset.reshape(n, dg, taps, 2, ho, wo)
    ty = torch.tensor([t // kw * dh for t in range(taps)], **kw_)
    tx = torch.tensor([t % kw * dw for t in range(taps)], **kw_)
    # sample positions (N, dg, taps, Ho, Wo)
    base_y = oy[:, None] + ty[:, None, None] + off[:, :, :, 0]
    base_x = ox[None, :] + tx[:, None, None] + off[:, :, :, 1]
    # each group's channels sampled at its positions: (N*dg, cg, taps*L)
    samp = _bilinear_nchw(data.reshape(n * dg, cg, h, w),
                          base_y.reshape(n * dg, -1),
                          base_x.reshape(n * dg, -1))
    col = samp.reshape(n, dg, cg, taps, ho, wo)
    if mask is not None:
        col = col * mask.reshape(n, dg, 1, taps, ho, wo)
    col = col.reshape(n, c * taps, ho * wo)             # (C, taps) major
    with _f32_products((col, weight)):
        if num_group == 1:
            out = torch.matmul(weight.reshape(o, -1), col)
        else:
            og, cgr = o // num_group, c // num_group
            out = torch.matmul(
                weight.reshape(num_group, og, cgr * taps)[None],
                col.reshape(n, num_group, cgr * taps, ho * wo))
    out = out.reshape(n, o, ho, wo)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def _deformable_convolution(*args, kernel=(3, 3), stride=(1, 1),
                            pad=(0, 0), dilate=(1, 1), num_filter=0,
                            num_group=1, num_deformable_group=1,
                            no_bias=False, workspace=None, layout=None):
    """DCN v1: data (N, C, H, W), offset (N, 2*dg*kh*kw, Ho, Wo) as (y, x)
    per tap, weight (O, C/g, kh, kw), optional bias."""
    data, offset, weight = args[0], args[1], args[2]
    bias = args[3] if (not no_bias and len(args) > 3) else None
    return _deformable_conv_core(
        data, offset, weight, bias, None, tuple(kernel), tuple(stride),
        tuple(pad), tuple(dilate), int(num_deformable_group),
        int(num_group))


def _modulated_deformable_convolution(*args, kernel=(3, 3), stride=(1, 1),
                                      pad=(0, 0), dilate=(1, 1),
                                      num_filter=0, num_group=1,
                                      num_deformable_group=1,
                                      no_bias=False, workspace=None,
                                      layout=None, im2col_step=None):
    """DCN v2: v1 with a mask (N, dg*kh*kw, Ho, Wo) on each tap."""
    data, offset, mask, weight = args[0], args[1], args[2], args[3]
    bias = args[4] if (not no_bias and len(args) > 4) else None
    return _deformable_conv_core(
        data, offset, weight, bias, mask, tuple(kernel), tuple(stride),
        tuple(pad), tuple(dilate), int(num_deformable_group),
        int(num_group))


def _deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                              output_dim=1, group_size=1, pooled_size=7,
                              part_size=0, sample_per_part=1,
                              trans_std=0.0, no_trans=False):
    """PSROIPooling whose bins are shifted by learned offsets (normalized
    by the roi's size); each bin averages ``sample_per_part^2`` bilinear
    samples of its own channel. Returns (R, output_dim, p, p)."""
    p = int(pooled_size)
    g = int(group_size)
    sp = int(sample_per_part)
    n, c, hh, ww = data.shape
    r = rois.shape[0]
    dev = data.device
    f32 = dict(dtype=torch.float32, device=dev)
    b = rois[:, 0].to(torch.int64)
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bh, bw = rh / p, rw / p
    it = torch.arange(p, **f32)
    if no_trans or trans is None:
        off_y = torch.zeros((r, p, p), **f32)
        off_x = torch.zeros((r, p, p), **f32)
    else:
        pt = int(part_size) if part_size else p
        bin_p = torch.clamp(torch.div(torch.arange(p, device=dev) * pt, p,
                                      rounding_mode="floor"), 0, pt - 1)
        tr = trans[:, :, bin_p[:, None], bin_p[None, :]]   # (R, 2, p, p)
        off_y = tr[:, 0] * trans_std * rh[:, None, None]
        off_x = tr[:, 1] * trans_std * rw[:, None, None]
    gi = torch.div(torch.arange(p, device=dev) * g, p, rounding_mode="floor")
    cidx = (torch.arange(output_dim, device=dev)[:, None, None] * g * g
            + gi[None, :, None] * g + gi[None, None, :])   # (od, p, p)
    by = y1[:, None, None] + it[None, :, None] * bh[:, None, None]
    bx = x1[:, None, None] + it[None, None, :] * bw[:, None, None]
    sy = (torch.arange(sp, **f32) + 0.5) * (bh[:, None] / sp)   # (R, sp)
    sx = (torch.arange(sp, **f32) + 0.5) * (bw[:, None] / sp)
    yy = by[..., None, None] + sy[:, None, None, :, None] + \
        off_y[..., None, None]
    xx = bx[..., None, None] + sx[:, None, None, None, :] + \
        off_x[..., None, None]
    yy, xx = torch.broadcast_tensors(yy, xx)               # (R, p, p, sp, sp)
    # only the channel each output bin reads: (R, od, p, p, sp, sp)
    yy = yy[:, None].expand(r, output_dim, p, p, sp, sp)
    xx = xx[:, None].expand(r, output_dim, p, p, sp, sp)
    ch = cidx[None, :, :, :, None, None].expand_as(yy)
    planes = data.reshape(n * c, hh * ww)
    plane = b[:, None, None, None, None, None] * c + ch
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    wy = yy - y0
    wx = xx - x0
    out = 0.0
    for dy, wgt_y in ((0, 1 - wy), (1, wy)):
        for dx, wgt_x in ((0, 1 - wx), (1, wx)):
            ya = y0 + dy
            xa = x0 + dx
            inside = (ya >= 0) & (ya <= hh - 1) & (xa >= 0) & (xa <= ww - 1)
            yi = torch.clamp(ya, 0, hh - 1).to(torch.int64)
            xi = torch.clamp(xa, 0, ww - 1).to(torch.int64)
            val = planes[plane, yi * ww + xi]
            out = out + (wgt_y * wgt_x * inside.to(data.dtype)) * val
    return out.mean(dim=(4, 5)).to(data.dtype)


# ------------------------------------------------------------ rroi align --
def _rroi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
                sampling_ratio=-1):
    """Rotated ROI align: rois (R, 6) [batch, cx, cy, w, h,
    theta_degrees]; bilinear samples (zero outside) on the rotated grid,
    averaged per bin. Returns (R, C, PH, PW)."""
    ph, pw = (pooled_size if hasattr(pooled_size, "__len__")
              else (pooled_size, pooled_size))
    sr = sampling_ratio if sampling_ratio > 0 else 2
    n, c, h, w = data.shape
    r = rois.shape[0]
    f32 = dict(dtype=rois.dtype, device=rois.device)
    b = rois[:, 0].to(torch.int64)
    cx = rois[:, 1] * spatial_scale
    cy = rois[:, 2] * spatial_scale
    rw = torch.clamp(rois[:, 3] * spatial_scale, min=1.0)
    rh = torch.clamp(rois[:, 4] * spatial_scale, min=1.0)
    theta = rois[:, 5] * math.pi / 180.0
    cos_t = torch.cos(theta)[:, None, None]
    sin_t = torch.sin(theta)[:, None, None]
    gy = (torch.arange(ph * sr, **f32) + 0.5) / (ph * sr) - 0.5
    gx = (torch.arange(pw * sr, **f32) + 0.5) / (pw * sr) - 0.5
    ly = (gy[None, :] * rh[:, None])[:, :, None].expand(r, ph * sr, pw * sr)
    lx = (gx[None, :] * rw[:, None])[:, None, :].expand(r, ph * sr, pw * sr)
    ix = cx[:, None, None] + lx * cos_t - ly * sin_t
    iy = cy[:, None, None] + lx * sin_t + ly * cos_t
    samples = _sample_rois(data, b, iy.reshape(r, -1), ix.reshape(r, -1))
    return samples.reshape(r, c, ph, sr, pw, sr).mean(dim=(3, 5))


def _sample_rois(data, b, y, x):
    """Bilinear samples (zero outside) of image ``b[r]`` at (R, P) points,
    gathered channels-last: (R, C, P)."""
    n, c, h, w = data.shape
    nhwc = data.permute(0, 2, 3, 1)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = y - y0
    wx = x - x0
    bb = b[:, None]
    out = 0.0
    for dy, wgt_y in ((0, 1 - wy), (1, wy)):
        for dx, wgt_x in ((0, 1 - wx), (1, wx)):
            yy = y0 + dy
            xx = x0 + dx
            inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            yi = torch.clamp(yy, 0, h - 1).to(torch.int64)
            xi = torch.clamp(xx, 0, w - 1).to(torch.int64)
            val = nhwc[bb, yi, xi]                      # (R, P, C)
            out = out + (wgt_y * wgt_x * inside.to(data.dtype))[..., None] \
                * val
    return out.permute(0, 2, 1)


# -------------------------------------------------------- mrcnn targets --
def _mrcnn_mask_target(rois, gt_masks, matches, cls_targets, num_rois=0,
                       num_classes=0, mask_size=(28, 28), sample_ratio=2,
                       aligned=False):
    """Each roi's matched GT mask cropped to ``mask_size`` by ROI align,
    broadcast to every class slot, and the one-hot class mask (class 0,
    the background, none). rois (B, R, 4), gt_masks (B, M, H, W),
    matches and cls_targets (B, R). Returns (B, R, classes, mh, mw)
    twice."""
    ms = (mask_size if hasattr(mask_size, "__len__")
          else (mask_size, mask_size))
    mh, mw = int(ms[0]), int(ms[1])
    bsz, r = matches.shape[:2]
    m, hh, ww = gt_masks.shape[1:4]
    sr = sample_ratio if sample_ratio > 0 else 2
    dt, dev = rois.dtype, rois.device
    x1, y1, x2, y2 = (rois[..., i] for i in range(4))
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    gy = y1[..., None] + (torch.arange(mh * sr, dtype=dt, device=dev)
                          + 0.5) * rh[..., None] / (mh * sr)
    gx = x1[..., None] + (torch.arange(mw * sr, dtype=dt, device=dev)
                          + 0.5) * rw[..., None] / (mw * sr)
    yy = gy[..., :, None].expand(bsz, r, mh * sr, mw * sr)
    xx = gx[..., None, :].expand(bsz, r, mh * sr, mw * sr)
    plane = (torch.arange(bsz, device=dev)[:, None] * m
             + matches.to(torch.int64)).reshape(-1)
    img = gt_masks.reshape(bsz * m, 1, hh, ww)[plane]       # (B*R, 1, H, W)
    s = _bilinear_nchw(img, yy.reshape(bsz * r, -1),
                       xx.reshape(bsz * r, -1))
    targets = s.reshape(bsz, r, mh, sr, mw, sr).mean(dim=(3, 5))
    cls = cls_targets.to(torch.int64)
    onehot = (torch.arange(num_classes, device=dev)[None, None, :]
              == cls[..., None]) & (cls[..., None] > 0)
    mask_cls = onehot.to(dt)[..., None, None] * torch.ones(
        (1, 1, 1, mh, mw), dtype=dt, device=dev)
    mask_targets = targets[:, :, None] * torch.ones(
        (1, 1, num_classes, 1, 1), dtype=dt, device=dev)
    return mask_targets, mask_cls


# ------------------------------------------------------------- hawkes ll --
def _hawkesll(lda, alpha, beta, state, lags, marks, valid_length,
              max_time):
    """Marked-Hawkes log-likelihood: lda (N, K), alpha (K,), beta (K,),
    state (N, K), lags (N, T), marks (N, T), valid_length (N,), max_time
    (N,). One step a event over the batch, in the JAX op's arithmetic.
    Returns (loglik (N,), out_state (N, K))."""
    n, k = lda.shape
    t_len = lags.shape[1]
    marks = marks.to(torch.int64)
    dev = lda.device
    last = torch.zeros((n, k), dtype=lda.dtype, device=dev)
    t = torch.zeros((n,), dtype=lda.dtype, device=dev)
    ll = torch.zeros((n,), dtype=lda.dtype, device=dev)
    zero = torch.zeros((), dtype=lda.dtype, device=dev)
    for j in range(t_len):
        lag = lags[:, j]
        mark = marks[:, j:j + 1]
        t = t + lag
        last_m = torch.gather(last, 1, mark)[:, 0]
        state_m = torch.gather(state, 1, mark)[:, 0]
        mu_m = torch.gather(lda, 1, mark)[:, 0]
        a_m, b_m = alpha[mark[:, 0]], beta[mark[:, 0]]
        d = t - last_m
        ed = torch.exp(-b_m * d)
        lam = mu_m + a_m * b_m * state_m * ed
        comp = mu_m * d + a_m * state_m * (1 - ed)
        valid = j < valid_length
        ll = ll + torch.where(valid, torch.log(lam) - comp, zero)
        state = state.scatter(1, mark, torch.where(
            valid, 1 + state_m * ed, state_m)[:, None])
        last = last.scatter(1, mark, torch.where(valid, t, last_m)[:, None])
        t = torch.where(valid, t, t - lag)
    d = max_time[:, None] - last
    ed = torch.exp(-beta * d)
    rem = lda * d + alpha * state * (1 - ed)
    return ll - rem.sum(dim=1), state * ed


_reg("_contrib_Proposal", _proposal, nout=2)
_reg("_contrib_MultiProposal", _multi_proposal, nout=2)
_reg("_contrib_PSROIPooling", _psroi_pooling)
_reg("_contrib_DeformableConvolution", _deformable_convolution)
_reg("_contrib_ModulatedDeformableConvolution",
     _modulated_deformable_convolution)
_reg("_contrib_DeformablePSROIPooling", _deformable_psroi_pooling)
_reg("_contrib_RROIAlign", _rroi_align)
_reg("_contrib_mrcnn_mask_target", _mrcnn_mask_target, nout=2,
     differentiable=False)
_reg("_contrib_hawkesll", _hawkesll, nout=2)

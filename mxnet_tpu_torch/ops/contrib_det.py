"""Object-detection contrib ops, the SSD/R-CNN family (the port of
``mxnet_tpu/ops/contrib_det.py``): ``_contrib_box_iou``,
``_contrib_MultiBoxPrior``, ``_contrib_MultiBoxTarget``,
``_contrib_MultiBoxDetection``, ``_contrib_box_nms`` and
``_contrib_ROIAlign``.

The port is held against the JAX ops, not MXNet's kernels, so it keeps
their deviations from MXNet (the JAX module's docstring lists them):
fixed output shapes, suppressed rows marked -1 instead of compacted, and
ROIAlign's ``sample_ratio <= 0`` resolved to a 2x2 grid.

Every op runs over the whole batch at once, as the JAX ops ``vmap``
theirs: the greedy bipartite match is G rounds over the (N, A, G) IoU
array, NMS is K steps over a (N, K, K) suppression array computed in one
pass. Both loops stay on the device (no host read per round), so the
ops can be captured in a CUDA graph. The sorts are stable
(``torch.sort(stable=True)``), as ``jnp.argsort`` is: every filtered
score is +-inf, so ties are the rule, and ``torch.topk`` promises no
order among them.
"""
from __future__ import annotations

import torch

from .registry import _REGISTRY, Operator

__all__ = ["corner_iou", "nms_keep"]

_EPS = 1e-12


def _reg(name, fn, **kw):
    _REGISTRY[name] = Operator(name, fn, **kw)


def corner_iou(a, b):
    """IoU between (..., A, 4) and (..., G, 4) corner boxes ->
    (..., A, G)."""
    ax1, ay1, ax2, ay2 = (a[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                     min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                     min=0.0)
    inter = iw * ih
    area_a = torch.clamp(ax2 - ax1, min=0.0) * torch.clamp(ay2 - ay1,
                                                           min=0.0)
    area_b = torch.clamp(bx2 - bx1, min=0.0) * torch.clamp(by2 - by1,
                                                           min=0.0)
    return inter / torch.clamp(area_a + area_b - inter, min=_EPS)


def _to_corner(b):
    x, y, w, h = (b[..., i] for i in range(4))
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def _box_iou(lhs, rhs, format="corner"):
    """Pairwise IoU: lhs (..., N, 4), rhs (..., M, 4) -> (..., N, M)."""
    if format == "center":
        lhs, rhs = _to_corner(lhs), _to_corner(rhs)
    return corner_iou(lhs, rhs)


def _stable_argsort(x, descending=False):
    return torch.sort(x, dim=-1, descending=descending, stable=True).indices


def _take(x, idx):
    """``x[n, idx[n]]`` along dim 1, trailing dims kept."""
    shape = idx.shape + x.shape[2:]
    full = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(shape)
    return torch.gather(x, 1, full)


def nms_keep(sup, keep):
    """Greedy suppression in score order over a batch: ``sup`` (N, K, K)
    bool says entry i suppresses entry j (already limited to j > i),
    ``keep`` (N, K) the entries alive at the start. K steps on the
    device, no host read: step i drops what a kept entry i suppresses."""
    for i in range(sup.shape[1]):
        keep = keep & ~(sup[:, i] & keep[:, i:i + 1])
    return keep


def _later(k, device):
    idx = torch.arange(k, device=device)
    return idx[None, :] > idx[:, None]


def _nms_mask(cls_ids, boxes, keep, nms_threshold, force_suppress):
    """The JAX op's ``_nms_mask`` over a batch: cls_ids (N, K), boxes
    (N, K, 4), keep (N, K)."""
    k = cls_ids.shape[1]
    sup = (corner_iou(boxes, boxes) >= nms_threshold) & \
        _later(k, boxes.device)
    if not force_suppress:
        sup = sup & (cls_ids[:, :, None] == cls_ids[:, None, :])
    return nms_keep(sup, keep)


# ---------------------------------------------------------- MultiBoxPrior --
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchors of an (N, C, H, W) feature map: (1, H*W*(sizes+ratios-1),
    4) corner boxes, per location every size at ratios[0], then sizes[0]
    at ratios[1:]; the width scaled by H/W (square in pixels at ratio
    1)."""
    sizes = tuple(float(s) for s in (sizes if hasattr(sizes, "__len__")
                                     else (sizes,)))
    ratios = tuple(float(r) for r in (ratios if hasattr(ratios, "__len__")
                                      else (ratios,)))
    h, w = data.shape[2], data.shape[3]
    f32 = dict(dtype=torch.float32, device=data.device)
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, **f32) + offsets[0]) * step_y
    cx = (torch.arange(w, **f32) + offsets[1]) * step_x
    cyx = torch.stack(torch.meshgrid(cy, cx, indexing="ij"), dim=-1)
    r0 = ratios[0] ** 0.5
    wh = [(s * h / w * r0 / 2, s / r0 / 2) for s in sizes]
    for r in ratios[1:]:
        rs = r ** 0.5
        wh.append((sizes[0] * h / w * rs / 2, sizes[0] / rs / 2))
    wh = torch.tensor(wh, **f32)
    cxy = cyx[:, :, None, [1, 0]]
    boxes = torch.cat([cxy - wh[None, None], cxy + wh[None, None]], dim=-1)
    boxes = boxes.reshape(1, -1, 4)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes.to(data.dtype)


# --------------------------------------------------------- MultiBoxTarget --
def _bipartite(iou):
    """Stage 1 of the match: G rounds, each the best remaining (anchor,
    gt) pair of every image (the first on a tie, as ``jnp.argmax``).
    iou (N, A, G) -> (matched gt (N, A) int64, -1 where none; the
    anchors matched (N, A) bool)."""
    n, a, g = iou.shape
    dev = iou.device
    matched = torch.full((n, a), -1, dtype=torch.int64, device=dev)
    a_used = torch.zeros((n, a), dtype=torch.bool, device=dev)
    g_used = torch.zeros((n, g), dtype=torch.bool, device=dev)
    ar_a = torch.arange(a, device=dev)[None]
    ar_g = torch.arange(g, device=dev)[None]
    neg = torch.full((), -1.0, dtype=iou.dtype, device=dev)
    for _ in range(g):
        m = torch.where(a_used[:, :, None] | g_used[:, None, :], neg, iou)
        flat = torch.argmax(m.reshape(n, -1), dim=1)
        val = torch.gather(m.reshape(n, -1), 1, flat[:, None])[:, 0]
        aj, gk = flat // g, flat % g
        ok = (val > 1e-6)[:, None]
        hit_a = ok & (ar_a == aj[:, None])
        matched = torch.where(hit_a, gk[:, None], matched)
        a_used = a_used | hit_a
        g_used = g_used | (ok & (ar_g == gk[:, None]))
    return matched, a_used


def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5,
                     minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """Training targets. anchor (1, A, 4); label (N, G, >=5) rows [cls,
    x1, y1, x2, y2, ...] padded with -1; cls_pred (N, C, A) logits.
    Returns loc_target (N, A*4), loc_mask (N, A*4), cls_target (N, A)."""
    anchors = anchor.reshape(-1, 4)
    n = label.shape[0]
    A = anchors.shape[0]
    dt, dev = anchors.dtype, anchors.device
    valid_gt = label[:, :, 0] >= 0                              # (N, G)
    iou = corner_iou(anchors[None], label[:, :, 1:5])           # (N, A, G)
    iou = torch.where(valid_gt[:, None, :], iou,
                      torch.full((), -1.0, dtype=iou.dtype, device=dev))
    matched, anchor_pos = _bipartite(iou)
    best_iou = torch.amax(iou, dim=2)
    best_gt = torch.argmax(iou, dim=2)
    if overlap_threshold > 0:
        thr_pos = ~anchor_pos & (best_iou > overlap_threshold)
    else:
        thr_pos = torch.zeros_like(anchor_pos)
    positive = anchor_pos | thr_pos
    matched = torch.where(anchor_pos, matched, best_gt)
    num_pos = positive.sum(dim=1, dtype=torch.int32)            # (N,)
    if negative_mining_ratio > 0:
        # hard negatives: the lowest background probability first
        bg_prob = torch.softmax(cls_pred.transpose(1, 2).to(torch.float32),
                                dim=-1)[..., 0]                 # (N, A)
        candidate = ~positive & (best_iou < negative_mining_thresh)
        num_neg = torch.clamp(
            (num_pos * torch.tensor(negative_mining_ratio,
                                    dtype=torch.float32, device=dev)
             ).to(torch.int32), min=int(minimum_negative_samples))
        num_neg = torch.minimum(num_neg, A - num_pos)
        score = torch.where(candidate, bg_prob,
                            torch.full((), float("inf"), device=dev))
        order = _stable_argsort(score)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(A, device=dev).expand(n, A))
        negative = candidate & (rank < num_neg[:, None])
    else:
        negative = ~positive
    gt = _take(label, matched)                                  # (N, A, K)
    g_box = gt[..., 1:5]
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    gw = torch.clamp(g_box[..., 2] - g_box[..., 0], min=_EPS)
    gh = torch.clamp(g_box[..., 3] - g_box[..., 1], min=_EPS)
    gx = (g_box[..., 0] + g_box[..., 2]) * 0.5
    gy = (g_box[..., 1] + g_box[..., 3]) * 0.5
    v0, v1, v2, v3 = variances
    loc = torch.stack([(gx - ax) / aw / v0, (gy - ay) / ah / v1,
                       torch.log(gw / aw) / v2, torch.log(gh / ah) / v3],
                      dim=-1)
    zero = torch.zeros((), dtype=loc.dtype, device=dev)
    loc_mask = positive[..., None].expand(n, A, 4)
    loc_target = torch.where(loc_mask, loc, zero)
    ign = torch.full((), float(ignore_label), dtype=label.dtype, device=dev)
    cls_target = torch.where(positive, gt[..., 0] + 1.0,
                             torch.where(negative, zero.to(label.dtype),
                                         ign))
    # no valid gt: everything stays at its initial value (loc 0, mask 0,
    # cls ignore_label)
    any_gt = valid_gt.any(dim=1)
    loc_target = torch.where(any_gt[:, None, None], loc_target, zero)
    loc_mask = torch.where(any_gt[:, None, None], loc_mask.to(dt),
                           zero.to(dt))
    cls_target = torch.where(any_gt[:, None], cls_target, ign)
    return (loc_target.reshape(n, -1).to(dt), loc_mask.reshape(n, -1),
            cls_target.to(dt))


# ------------------------------------------------------ MultiBoxDetection --
def _decode_boxes(anchors, loc_pred, variances, clip):
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    v0, v1, v2, v3 = variances
    ox = loc_pred[..., 0] * v0 * aw + ax
    oy = loc_pred[..., 1] * v1 * ah + ay
    ow = torch.exp(loc_pred[..., 2] * v2) * aw / 2
    oh = torch.exp(loc_pred[..., 3] * v3) * ah / 2
    boxes = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes


def _multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                        threshold=0.01, background_id=0,
                        nms_threshold=0.5, force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode and NMS. cls_prob (N, C, A) probabilities (class
    ``background_id`` the background); loc_pred (N, A*4); anchor (1, A,
    4). Returns (N, A, 6) rows [class_id, score, x1, y1, x2, y2] sorted
    by score, suppressed and empty rows class_id -1."""
    n, C, A = cls_prob.shape
    dev = cls_prob.device
    boxes = _decode_boxes(anchor.reshape(1, -1, 4),
                          loc_pred.reshape(n, A, 4), variances, clip)
    fg_mask = torch.arange(C, device=dev) != background_id
    fg = torch.where(fg_mask[None, :, None], cls_prob,
                     torch.full((), float("-inf"), dtype=cls_prob.dtype,
                                device=dev))
    score = torch.amax(fg, dim=1)
    raw_id = torch.argmax(fg, dim=1)
    # ids are 0-based foreground ids (the background excluded)
    cls_id = torch.where(raw_id > background_id, raw_id - 1,
                         raw_id).to(torch.float32)
    valid = score >= threshold
    neg1 = torch.full((), -1.0, device=dev)
    cls_id = torch.where(valid, cls_id, neg1)
    order = _stable_argsort(torch.where(
        valid, -score, torch.full((), float("inf"), dtype=score.dtype,
                                  device=dev)))
    cls_s = torch.gather(cls_id, 1, order)
    score_s = torch.gather(score, 1, order)
    boxes_s = _take(boxes, order)
    keep = cls_s >= 0
    if 0 < nms_threshold <= 1:
        # the top-K candidates only: the IoU array is (K, K), not (A, A)
        k = min(nms_topk, A) if nms_topk > 0 else A
        keep_k = _nms_mask(cls_s[:, :k], boxes_s[:, :k], keep[:, :k],
                           nms_threshold, force_suppress)
        keep = torch.cat([keep_k, torch.zeros_like(keep[:, k:])], dim=1)
    elif nms_topk > 0:
        keep = keep & (torch.arange(A, device=dev) < nms_topk)
    cls_s = torch.where(keep, cls_s, neg1)
    return torch.cat([cls_s[..., None], score_s[..., None].to(cls_s.dtype),
                      boxes_s.to(cls_s.dtype)], dim=-1).to(cls_prob.dtype)


# ----------------------------------------------------------------- NMS -----
def _box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
             coord_start=2, score_index=1, id_index=-1,
             force_suppress=False, in_format="corner",
             out_format="corner"):
    """Box NMS over (..., N, K) rows with the score at ``score_index``,
    the box at ``coord_start:coord_start+4`` and an optional class at
    ``id_index``: rows sorted by score, suppressed rows overwritten with
    -1."""
    shape = data.shape
    d = data.reshape((-1,) + tuple(shape[-2:]))
    b, n = d.shape[:2]
    dev = d.device
    score = d[..., score_index]
    boxes = d[..., coord_start:coord_start + 4]
    if in_format == "center":
        boxes = _to_corner(boxes)
    ids = d[..., id_index] if id_index >= 0 else \
        torch.zeros((b, n), dtype=d.dtype, device=dev)
    valid = score > valid_thresh
    order = _stable_argsort(torch.where(
        valid, -score, torch.full((), float("inf"), dtype=score.dtype,
                                  device=dev)))
    d_s = _take(d, order)
    boxes_s = _take(boxes, order)
    ids_s = torch.gather(ids, 1, order)
    keep = torch.gather(valid, 1, order)
    k = min(topk, n) if topk > 0 else n
    keep = keep & (torch.arange(n, device=dev) < k)
    neg1 = torch.full((), -1.0, dtype=d.dtype, device=dev)
    keep_k = _nms_mask(torch.where(keep[:, :k], ids_s[:, :k], neg1),
                       boxes_s[:, :k], keep[:, :k], overlap_thresh,
                       force_suppress or id_index < 0)
    keep = torch.cat([keep_k, torch.zeros_like(keep[:, k:])], dim=1)
    out = torch.where(keep[..., None], d_s, neg1)
    if out_format != in_format:
        bx = out[..., coord_start:coord_start + 4]
        if out_format == "center":
            conv = torch.stack([(bx[..., 0] + bx[..., 2]) / 2,
                                (bx[..., 1] + bx[..., 3]) / 2,
                                bx[..., 2] - bx[..., 0],
                                bx[..., 3] - bx[..., 1]], dim=-1)
        else:
            conv = _to_corner(bx)
        out = torch.cat([out[..., :coord_start],
                         torch.where(keep[..., None], conv, neg1),
                         out[..., coord_start + 4:]], dim=-1)
    return out.reshape(shape)


# ------------------------------------------------------------- ROIAlign ----
def _roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
               sample_ratio=-1, position_sensitive=False, aligned=False):
    """ROI align. data (N, C, H, W); rois (R, 5) rows [batch_idx, x1, y1,
    x2, y2] in image coordinates. Returns (R, C, PH, PW) (position
    sensitive: (R, C/(PH*PW), PH, PW)). Each bin averages ``sr x sr``
    bilinear samples (``sample_ratio <= 0``: 2x2). The samples are
    gathered from a channels-last copy of ``data``, every roi at once;
    the gradient reaches ``data`` through the gathers."""
    ph, pw = (pooled_size if hasattr(pooled_size, "__len__")
              else (pooled_size, pooled_size))
    sr = sample_ratio if sample_ratio > 0 else 2
    n, c, h, w = data.shape
    r = rois.shape[0]
    offset = 0.5 if aligned else 0.0
    b = rois[:, 0].to(torch.int64)
    x1, y1, x2, y2 = (rois[:, i] * spatial_scale - offset
                      for i in range(1, 5))
    rw = x2 - x1
    rh = y2 - y1
    if not aligned:          # legacy: malformed rois forced to 1x1
        rw = torch.clamp(rw, min=1.0)
        rh = torch.clamp(rh, min=1.0)
    bh, bw = rh / ph, rw / pw
    kw = dict(dtype=rois.dtype, device=rois.device)
    gy = y1[:, None] + (torch.arange(ph * sr, **kw) + 0.5) * \
        bh[:, None] / sr                                  # (R, PH*sr)
    gx = x1[:, None] + (torch.arange(pw * sr, **kw) + 0.5) * \
        bw[:, None] / sr
    yy = gy[:, :, None].expand(r, ph * sr, pw * sr).reshape(r, -1)
    xx = gx[:, None, :].expand(r, ph * sr, pw * sr).reshape(r, -1)
    yy = torch.clamp(yy, 0.0, h - 1.0)
    xx = torch.clamp(xx, 0.0, w - 1.0)
    y0 = torch.floor(yy).to(torch.int64)
    x0 = torch.floor(xx).to(torch.int64)
    y1i = torch.clamp(y0 + 1, max=h - 1)
    x1i = torch.clamp(x0 + 1, max=w - 1)
    wy = (yy - y0)[..., None]
    wx = (xx - x0)[..., None]
    nhwc = data.permute(0, 2, 3, 1)
    bb = b[:, None]

    def g(yi, xi):
        return nhwc[bb, yi, xi]                           # (R, P, C)
    samples = ((1 - wy) * (1 - wx)) * g(y0, x0) + \
        ((1 - wy) * wx) * g(y0, x1i) + \
        (wy * (1 - wx)) * g(y1i, x0) + \
        (wy * wx) * g(y1i, x1i)
    pooled = samples.reshape(r, ph, sr, pw, sr, c).mean(dim=(2, 4))
    pooled = pooled.permute(0, 3, 1, 2)                   # (R, C, PH, PW)
    if position_sensitive:
        cc = c // (ph * pw)
        pooled = pooled.reshape(r, cc, ph, pw, ph, pw)
        i = torch.arange(ph, device=data.device)[:, None]
        j = torch.arange(pw, device=data.device)[None, :]
        pooled = pooled[:, :, i, j, i, j]
    return pooled.to(data.dtype)


_reg("_contrib_box_iou", _box_iou)
_reg("_contrib_MultiBoxPrior", _multibox_prior, differentiable=False)
_reg("_contrib_MultiBoxTarget", _multibox_target, nout=3,
     differentiable=False)
_reg("_contrib_MultiBoxDetection", _multibox_detection,
     differentiable=False)
_reg("_contrib_box_nms", _box_nms)
_reg("_contrib_ROIAlign", _roi_align)

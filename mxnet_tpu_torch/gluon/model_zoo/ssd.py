"""SSD, the Single Shot MultiBox Detector, on VGG16-reduced at 300x300
(mirrors ``mxnet_tpu/gluon/model_zoo/ssd.py``): the backbone with a
dilated fc6 and a 1x1 fc7, four extra stages, one class and one box head
a stage, anchors from the registry's ``_contrib_MultiBoxPrior``, and
``MultiBoxLoss`` over ``_contrib_MultiBoxTarget`` (hard negatives 3:1).
Names and shapes are the reference's, so its parameters carry across by
``convert.load_gluon_params``."""
from __future__ import annotations

import torch

from ... import initializer
from .. import nn
from ..block import HybridBlock, _F
from ..loss import Loss

__all__ = ["SSD", "MultiBoxLoss", "ssd_300_vgg16_reduced", "vgg16_reduced"]


class _L2NormScale(HybridBlock):
    """Channel-wise L2 normalization times a learned per-channel scale
    (initially 20), on the first feature map."""

    def __init__(self, n_channel, initial=20.0, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.scale = self.params.get(
                "scale", shape=(1, n_channel, 1, 1),
                init=initializer.Constant(initial))

    def hybrid_forward(self, F, x, scale=None):
        return F.L2Normalization(x, mode="channel") * scale


def vgg16_reduced():
    """VGG16 to relu4_3 (ceil-mode pooling: 300 -> 150 -> 75 -> 38), and
    the rest: pool4, conv5, a 3x3/1 pool5, the dilated fc6 and 1x1 fc7.
    Returns the two stages."""
    cfg = [(2, 64), (2, 128), (3, 256), (3, 512)]
    up_to_relu43 = nn.HybridSequential(prefix="")
    for i, (n, ch) in enumerate(cfg):
        for _ in range(n):
            up_to_relu43.add(nn.Conv2D(ch, 3, padding=1,
                                       activation="relu"))
        if i < len(cfg) - 1:
            up_to_relu43.add(nn.MaxPool2D(2, 2, ceil_mode=True))
    rest = nn.HybridSequential(prefix="")
    rest.add(nn.MaxPool2D(2, 2, ceil_mode=True))
    for _ in range(3):
        rest.add(nn.Conv2D(512, 3, padding=1, activation="relu"))
    rest.add(nn.MaxPool2D(3, 1, 1))
    rest.add(nn.Conv2D(1024, 3, padding=6, dilation=6, activation="relu"))
    rest.add(nn.Conv2D(1024, 1, activation="relu"))
    return up_to_relu43, rest


def _extra_layers(spec):
    """The extra stages: a 1x1 conv to ``mid`` channels, then a 3x3 conv
    to ``out`` of ``stride`` and ``pad``, each (mid, out, stride, pad)."""
    stages = []
    for mid, out, stride, pad in spec:
        s = nn.HybridSequential(prefix="")
        s.add(nn.Conv2D(mid, 1, activation="relu"))
        s.add(nn.Conv2D(out, 3, strides=stride, padding=pad,
                        activation="relu"))
        stages.append(s)
    return stages


class SSD(HybridBlock):
    """A generic SSD: ``stages`` run in turn, each one's output feeding a
    class head and a box head; ``sizes``/``ratios``/``steps`` a stage's
    anchors. A call returns (class predictions (N, C+1, A), box
    predictions (N, A*4), anchors (1, A, 4))."""

    def __init__(self, stages, sizes, ratios, steps, classes,
                 l2_norm_channels=None, **kwargs):
        super().__init__(**kwargs)
        if not len(stages) == len(sizes) == len(ratios) == len(steps):
            raise ValueError("stages, sizes, ratios and steps differ in "
                             "length")
        self._num_classes = classes
        self._sizes = sizes
        self._ratios = ratios
        self._steps = steps
        with self.name_scope():
            self.stages = nn.HybridSequential(prefix="stages_")
            for s in stages:
                self.stages.add(s)
            self.norm = (_L2NormScale(l2_norm_channels, prefix="l2norm_")
                         if l2_norm_channels else None)
            self.cls_heads = nn.HybridSequential(prefix="cls_")
            self.loc_heads = nn.HybridSequential(prefix="loc_")
            for sz, rt in zip(sizes, ratios):
                k = len(sz) + len(rt) - 1
                self.cls_heads.add(nn.Conv2D(k * (classes + 1), 3,
                                             padding=1))
                self.loc_heads.add(nn.Conv2D(k * 4, 3, padding=1))

    def forward(self, x):
        cls_preds, loc_preds, anchors = [], [], []
        feat = x
        for i, stage in enumerate(self.stages):
            feat = stage(feat)
            f = self.norm(feat) if (i == 0 and self.norm is not None) \
                else feat
            c = self.cls_heads[i](f)
            loc = self.loc_heads[i](f)
            n = c.shape[0]
            # (N, K*(C+1), H, W) -> (N, H*W*K, C+1)
            cls_preds.append(c.permute(0, 2, 3, 1).reshape(
                n, -1, self._num_classes + 1))
            loc_preds.append(loc.permute(0, 2, 3, 1).reshape(n, -1))
            anchors.append(_F._contrib_MultiBoxPrior(
                f, sizes=self._sizes[i], ratios=self._ratios[i],
                steps=(self._steps[i], self._steps[i]), clip=False))
        return (torch.cat(cls_preds, dim=1).permute(0, 2, 1),
                torch.cat(loc_preds, dim=1), torch.cat(anchors, dim=1))

    def detect(self, x, nms_threshold=0.45, threshold=0.01, nms_topk=400):
        """Inference: forward, softmax, box decoding and NMS; (N, A, 6)
        rows [class_id, score, x1, y1, x2, y2], -1 where suppressed."""
        cls_preds, loc_preds, anchors = self(x)
        probs = torch.softmax(cls_preds, dim=1)
        return _F._contrib_MultiBoxDetection(
            probs, loc_preds, anchors, nms_threshold=nms_threshold,
            threshold=threshold, nms_topk=nms_topk)


class MultiBoxLoss(Loss):
    """SSD's training loss: softmax cross-entropy over the anchors that
    ``MultiBoxTarget`` assigns (positives, and hard negatives at
    ``negative_mining_ratio`` to one; the rest ignored) plus ``lambd``
    times smooth L1 on the positives' boxes, each normalised by its
    count. A call (class predictions, box predictions, labels (N, G, 6),
    anchors) returns the loss of each sample (N,)."""

    def __init__(self, negative_mining_ratio=3.0, lambd=1.0,
                 overlap_threshold=0.5, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._ratio = negative_mining_ratio
        self._lambd = lambd
        self._thresh = overlap_threshold

    def hybrid_forward(self, F, cls_preds, loc_preds, label, anchors):
        # the targets carry no gradient: the predictions only rank there
        loc_t, loc_m, cls_t = F._contrib_MultiBoxTarget(
            anchors, label, cls_preds.detach(),
            overlap_threshold=self._thresh,
            negative_mining_ratio=self._ratio,
            negative_mining_thresh=0.5)
        logp = F.log_softmax(cls_preds.permute(0, 2, 1), axis=-1)
        picked = -F.pick(logp, torch.clamp(cls_t, min=0), axis=-1)
        keep = (cls_t >= 0).to(logp.dtype)
        cls_loss = (picked * keep).sum(dim=-1) / \
            torch.clamp(keep.sum(dim=-1), min=1.0)
        loc_loss = (F.smooth_l1(loc_preds - loc_t, scalar=1.0) * loc_m
                    ).sum(dim=-1) / torch.clamp(loc_m.sum(dim=-1), min=1.0)
        return cls_loss + self._lambd * loc_loss


def ssd_300_vgg16_reduced(classes=20, **kwargs):
    """SSD-300 on VGG16-reduced: six stages (38, 19, 10, 5, 3, 1 on a 300
    x 300 input), 8732 anchors."""
    base43, base7 = vgg16_reduced()
    extras = _extra_layers([(256, 512, 2, 1), (128, 256, 2, 1),
                            (128, 256, 1, 0), (128, 256, 1, 0)])
    sizes = [(0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
             (0.71, 0.79), (0.88, 0.961)]
    ratios = [(1.0, 2.0, 0.5)] + [(1.0, 2.0, 0.5, 3.0, 1.0 / 3)] * 3 + \
        [(1.0, 2.0, 0.5)] * 2
    steps = [8 / 300, 16 / 300, 32 / 300, 64 / 300, 100 / 300, 1.0]
    return SSD([base43, base7] + extras, sizes, ratios, steps, classes,
               l2_norm_channels=512, **kwargs)

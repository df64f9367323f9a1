"""Detection image iterator + bbox-aware augmenters (mirrors
``mxnet_tpu/image/detection.py``).

Reference: python/mxnet/image/detection.py (DetAugmenter zoo, ImageDetIter
— labels are [header_width, obj_width, class, xmin, ymin, xmax, ymax,
...] per image). Subset: the core crop/flip/resize augmenters that adjust
boxes, and ImageDetIter over .rec/.lst.
"""
from __future__ import annotations

import random as pyrandom

import numpy as _np

from ..ndarray import NDArray, array as nd_array
from .image import (Augmenter, imresize, ImageIter, CastAug,
                    ColorNormalizeAug)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetResizeAug", "CreateDetAugmenter",
           "ImageDetIter"]


class DetAugmenter:
    """Detection augmenter: __call__(src, label) (reference:
    detection.py:40)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap an image-only augmenter (reference: detection.py:71)."""

    def __init__(self, augmenter):
        super().__init__()
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__()
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if pyrandom.random() >= self.skip_prob and self.aug_list:
            aug = pyrandom.choice(self.aug_list)
            src, label = aug(src, label)
        return src, label


class DetHorizontalFlipAug(DetAugmenter):
    """Flip image + boxes (reference: detection.py:114)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            src = nd_array(src.asnumpy()[:, ::-1].copy())
            label = label.copy()
            valid = label[:, 0] >= 0
            tmp = 1.0 - label[valid, 1]
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = tmp
        return src, label


class DetResizeAug(DetAugmenter):
    """Resize only (boxes are relative, unchanged)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size
        self.interp = interp

    def __call__(self, src, label):
        return imresize(src, self.size[0], self.size[1],
                        self.interp), label


def CreateDetAugmenter(data_shape, resize=0, rand_mirror=False, mean=None,
                       std=None, **kwargs):
    """reference: detection.py:500."""
    auglist = [DetResizeAug((data_shape[2], data_shape[1]))]
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None and std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator (reference: detection.py:562). Labels are 2-D
    (max_objects, 5): [class, xmin, ymin, xmax, ymax] normalized."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, shuffle=False,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="label", max_objects=50, **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_mirror", "mean", "std")})
        self.max_objects = max_objects
        super().__init__(batch_size, data_shape, label_width=1,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, shuffle=shuffle,
                         aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name)
        self.det_auglist = aug_list
        from ..io.io import DataDesc
        self.provide_label = [DataDesc(
            label_name, (batch_size, max_objects, 5))]

    def _parse_label(self, label):
        """Flat record label → (N,5) array (reference:
        detection.py _parse_label: [hw, ow, cls,x1,y1,x2,y2,...])."""
        raw = _np.asarray(label, dtype=_np.float32).ravel()
        if raw.size < 2:
            return _np.full((self.max_objects, 5), -1, _np.float32)
        hw = int(raw[0])
        ow = int(raw[1])
        body = raw[hw:]
        n = body.size // ow
        out = _np.full((self.max_objects, 5), -1, dtype=_np.float32)
        for i in range(min(n, self.max_objects)):
            rec = body[i * ow:(i + 1) * ow]
            out[i, 0] = rec[0]
            out[i, 1:5] = rec[1:5]
        return out

    def next(self):
        batch_data = _np.zeros((self.batch_size,) + self.data_shape,
                               dtype=self.dtype)
        batch_label = _np.full(
            (self.batch_size, self.max_objects, 5), -1, dtype=self.dtype)
        i = 0
        pad = 0
        while i < self.batch_size:
            try:
                label, img = self.next_sample()
            except StopIteration:
                if i == 0:
                    raise
                pad = self.batch_size - i
                break
            lab = self._parse_label(label)
            data = nd_array(img)
            for aug in self.det_auglist:
                data, lab = aug(data, lab)
            a = data.asnumpy()
            if a.ndim == 3 and a.shape[2] == self.data_shape[0]:
                a = a.transpose(2, 0, 1)
            batch_data[i] = a
            batch_label[i] = lab
            i += 1
        return self._DataBatch(data=[nd_array(batch_data)],
                               label=[nd_array(batch_label)], pad=pad)

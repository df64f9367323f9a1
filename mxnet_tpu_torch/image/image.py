"""Image loading, the pure-Python augmenters and ImageIter (mirrors
``mxnet_tpu/image/image.py``).

Reference: python/mxnet/image/image.py (imread/imdecode/imresize,
Augmenter zoo, ImageIter over .rec or .lst). Decode and resize run on the
host through cv2, as the reference's CPU path (src/io/image_aug_default.cc
used OpenCV too). The arithmetic is the reference's: each image is an
NDArray on the current context (the card unless a ``with mx.cpu():``
block says otherwise), and each augmenter reads it back to the host and
hands on a new array; random draws come from Python's ``random`` (and
``LightingAug`` from numpy's) in the reference's order, so for a fixed
``random.seed`` crops and flips are the JAX package's.
"""
from __future__ import annotations

import os
import random as pyrandom

import numpy as _np

from ..base import MXNetError
from ..ndarray import NDArray, array as nd_array

__all__ = ["imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "color_normalize",
           "random_size_crop", "Augmenter", "SequentialAug", "RandomOrderAug",
           "ResizeAug", "ForceResizeAug", "RandomCropAug",
           "RandomSizedCropAug", "CenterCropAug", "HorizontalFlipAug",
           "CastAug", "ColorNormalizeAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "HueJitterAug",
           "ColorJitterAug", "LightingAug", "RandomGrayAug",
           "CreateAugmenter", "ImageIter"]


def _cv2():
    import cv2
    return cv2


def read_host(filename, flag=1, to_rgb=True):
    """Read an image file → HWC numpy array on the host."""
    cv2 = _cv2()
    img = cv2.imread(filename, flag)
    if img is None:
        raise MXNetError(f"cannot read image {filename}")
    if to_rgb and img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img


def imread(filename, flag=1, to_rgb=True):
    """Read image file → HWC NDArray (reference: image.py imread)."""
    return nd_array(read_host(filename, flag, to_rgb))


def imdecode(buf, flag=1, to_rgb=True):
    """Decode encoded bytes → HWC NDArray (reference: image.py imdecode —
    the C++ path was src/io/image_io.cc Imdecode)."""
    cv2 = _cv2()
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    img = cv2.imdecode(_np.frombuffer(buf, dtype=_np.uint8), flag)
    if img is None:
        raise MXNetError("cannot decode image")
    if to_rgb and img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return nd_array(img)


def imresize(src, w, h, interp=1):
    cv2 = _cv2()
    a = src.asnumpy() if isinstance(src, NDArray) else src
    out = cv2.resize(a, (w, h), interpolation=_cv_interp(interp))
    return nd_array(out)


def _cv_interp(interp):
    import cv2
    return {0: cv2.INTER_NEAREST, 1: cv2.INTER_LINEAR, 2: cv2.INTER_CUBIC,
            3: cv2.INTER_AREA, 4: cv2.INTER_LANCZOS4}.get(interp,
                                                          cv2.INTER_LINEAR)


def resize_short(src, size, interp=2):
    """Resize shorter edge to size (reference: image.py resize_short)."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    a = src.asnumpy() if isinstance(src, NDArray) else src
    out = a[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(out, size[0], size[1], interp)
    return nd_array(out)


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = pyrandom.randint(0, max(0, w - new_w))
    y0 = pyrandom.randint(0, max(0, h - new_h))
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size,
                     interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = max(0, (w - new_w) // 2)
    y0 = max(0, (h - new_h) // 2)
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size,
                     interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = pyrandom.uniform(*area) * src_area
        log_ratio = (_np.log(ratio[0]), _np.log(ratio[1]))
        new_ratio = _np.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round(_np.sqrt(target_area * new_ratio)))
        new_h = int(round(_np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    a = src.asnumpy().astype(_np.float32) if isinstance(src, NDArray) \
        else src.astype(_np.float32)
    a = a - mean
    if std is not None:
        a = a / std
    return nd_array(a)


class Augmenter:
    """Base augmenter (reference: image.py:570)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return nd_array(src.asnumpy()[:, ::-1].copy())
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = _np.asarray(mean) if mean is not None else None
        self.std = _np.asarray(std) if std is not None else None

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return nd_array(src.asnumpy().astype(_np.float32) * alpha)


class ContrastJitterAug(Augmenter):
    _coef = _np.array([[[0.299, 0.587, 0.114]]], dtype=_np.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        a = src.asnumpy().astype(_np.float32)
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        gray = (a * self._coef).sum() * 3.0 / a.size
        return nd_array(a * alpha + gray * (1 - alpha))


class SaturationJitterAug(Augmenter):
    _coef = _np.array([[[0.299, 0.587, 0.114]]], dtype=_np.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        a = src.asnumpy().astype(_np.float32)
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        gray = (a * self._coef).sum(axis=2, keepdims=True)
        return nd_array(a * alpha + gray * (1 - alpha))


class HueJitterAug(Augmenter):
    _to_yiq = _np.array([[0.299, 0.587, 0.114],
                         [0.596, -0.274, -0.321],
                         [0.211, -0.523, 0.311]])
    _from_yiq = _np.linalg.inv(_to_yiq)

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        a = src.asnumpy().astype(_np.float32)
        alpha = pyrandom.uniform(-self.hue, self.hue)
        u, w = _np.cos(alpha * _np.pi), _np.sin(alpha * _np.pi)
        rot = _np.array([[1, 0, 0], [0, u, -w], [0, w, u]])
        m = self._from_yiq @ rot @ self._to_yiq
        return nd_array(a @ m.T)


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval)
        self.eigvec = _np.asarray(eigvec)

    def __call__(self, src):
        alpha = _np.random.normal(0, self.alphastd, size=(3,))
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return nd_array(src.asnumpy().astype(_np.float32) + rgb)


class RandomGrayAug(Augmenter):
    _coef = _np.array([[0.299], [0.587], [0.114]], dtype=_np.float32)

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            a = src.asnumpy().astype(_np.float32)
            gray = a @ self._coef
            return nd_array(_np.broadcast_to(gray, a.shape).copy())
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Standard augmenter list (reference: image.py:1015)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None and std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter:
    """Image iterator over .rec or .lst files with augmentation
    (reference: image.py:1120 — the pure-Python analogue of the C++
    ImageRecordIter)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="softmax_label",
                 dtype="float32", last_batch_handle="pad", **kwargs):
        from .. import recordio
        from ..io.io import DataDesc, DataBatch
        assert path_imgrec or path_imglist or imglist is not None
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._DataBatch = DataBatch
        self.imgrec = None
        self.imglist = None
        self.seq = None
        if path_imgrec:
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            self.imgrec = recordio.MXIndexedRecordIO(idx_path, path_imgrec,
                                                     "r")
            self.seq = list(self.imgrec.keys)
        else:
            if path_imglist:
                entries = []
                with open(path_imglist) as fin:
                    for line in fin:
                        parts = line.strip().split("\t")
                        entries.append((float(parts[1]),
                                        parts[-1]))
                self.imglist = entries
            else:
                self.imglist = imglist
            self.path_root = path_root or "."
            self.seq = list(range(len(self.imglist)))
        if num_parts > 1:
            self.seq = self.seq[part_index::num_parts]
        self.shuffle = shuffle
        if aug_list is None:
            aug_list = CreateAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_resize",
                         "rand_mirror", "mean", "std", "brightness",
                         "contrast", "saturation", "hue", "pca_noise",
                         "rand_gray", "inter_method")})
        self.auglist = aug_list
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape)]
        self.provide_label = [DataDesc(label_name,
                                       (batch_size, label_width)
                                       if label_width > 1 else
                                       (batch_size,))]
        self.dtype = dtype
        self.cursor = 0
        self.reset()

    def reset(self):
        if self.shuffle:
            pyrandom.shuffle(self.seq)
        self.cursor = 0

    def __iter__(self):
        return self

    def next_sample(self):
        if self.cursor >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cursor]
        self.cursor += 1
        if self.imgrec is not None:
            from .. import recordio
            header, img = recordio.unpack_img(self.imgrec.read_idx(idx))
            return header.label, img
        label, fname = self.imglist[idx]
        img = imread(os.path.join(self.path_root, fname)).asnumpy()
        return label, img

    def next(self):
        batch_data = _np.zeros((self.batch_size,) + self.data_shape,
                               dtype=self.dtype)
        batch_label = _np.zeros(self.provide_label[0].shape[1:] and
                                (self.batch_size, self.label_width) or
                                (self.batch_size,), dtype=self.dtype)
        if self.label_width == 1:
            batch_label = _np.zeros((self.batch_size,), dtype=self.dtype)
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
            data = nd_array(img)
            for aug in self.auglist:
                data = aug(data)
            a = data.asnumpy()
            if a.ndim == 3 and a.shape[2] == self.data_shape[0]:
                a = a.transpose(2, 0, 1)  # HWC → CHW
            batch_data[i] = a
            if self.label_width == 1:
                batch_label[i] = label if _np.isscalar(label) else \
                    _np.asarray(label).reshape(-1)[0]
            else:
                batch_label[i] = _np.asarray(label).reshape(-1)[
                    :self.label_width]
            i += 1
        return self._DataBatch(data=[nd_array(batch_data)],
                               label=[nd_array(batch_label)], pad=pad)

    def __next__(self):
        return self.next()

"""Vision transforms of the port (mirrors
``mxnet_tpu/gluon/data/vision/transforms.py``). Transforms run on the
host, in numpy (inside DataLoader workers too), and return CPU NDArrays;
the random ones draw from numpy's global generator, as the reference's
do, so one seed gives the same crops and jitters in both packages.
``Resize`` interpolates as ``jax.image.resize`` does (a triangle kernel,
widened when downsampling; nearest takes the sample under each output
centre), computed here in numpy."""
from __future__ import annotations

import numpy as np
import torch

from ....ndarray.ndarray import NDArray
from ...block import Block
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomCrop",
           "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomHue", "RandomLighting", "RandomColorJitter"]


def _to_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host(a):
    a = np.ascontiguousarray(a)
    if a.dtype == np.float64:   # float32, as nd.array makes it
        a = a.astype(np.float32)
    return NDArray(torch.from_numpy(a))


class Compose(Sequential):
    """The transforms applied in turn to the first argument; the others
    pass through."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)

    def __call__(self, x, *args):
        for t in self._children_blocks():
            x = t(x)
        return (x,) + args if args else x

    def forward(self, x):
        return self(x)


class _Transform(Block):
    """A host transform: NDArray, tensor or array in, CPU NDArray out
    (not through ``Block.__call__``, which unwraps to tensors)."""

    def __call__(self, x):
        return self.forward(x)


class Cast(_Transform):
    """A cast to ``dtype``."""

    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        if isinstance(x, NDArray):
            return x.astype(self._dtype)
        return _host(_to_np(x).astype(self._dtype))


class ToTensor(_Transform):
    """HWC (or NHWC) uint8 in [0, 255] to CHW (NCHW) float32 in [0, 1]."""

    def forward(self, x):
        a = _to_np(x).astype(np.float32) / 255.0
        if a.ndim == 3:
            a = a.transpose(2, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(0, 3, 1, 2)
        return _host(a)


class Normalize(_Transform):
    """``(x - mean) / std`` a channel of a CHW image."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, dtype=np.float32)
        self._std = np.asarray(std, dtype=np.float32)

    def forward(self, x):
        a = _to_np(x).astype(np.float32)
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else \
            self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return _host((a - mean) / std)


def _linear_weights(n_in, n_out):
    """``jax.image``'s (n_in, n_out) triangle-kernel weights, antialiased
    (the kernel widened by n_in / n_out) when downsampling."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0)


def _resize_np(a, size, interp="bilinear"):
    """``a`` (HW or HWC) resized to ``size`` (h, w), as float32."""
    h, w = size if isinstance(size, (tuple, list)) else (size, size)
    a = np.asarray(a, np.float32)
    if interp not in ("bilinear", 1):
        for axis, n in ((0, h), (1, w)):
            m = a.shape[axis]
            if m != n:
                idx = np.floor((np.arange(n, dtype=np.float32) + 0.5)
                               * m / n).astype(np.int64)
                a = np.take(a, idx, axis=axis)
        return a
    out = a.astype(np.float64)
    for axis, n in ((0, h), (1, w)):
        m = out.shape[axis]
        if m != n:
            out = np.moveaxis(np.tensordot(out, _linear_weights(m, n),
                                           axes=([axis], [0])), -1, axis)
    return out.astype(np.float32)


class Resize(_Transform):
    """Resize to ``size`` (an int, or the reference's (w, h));
    ``keep_ratio`` scales the short side of an int size."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        a = _to_np(x)
        if isinstance(self._size, int):
            if self._keep:
                h, w = a.shape[:2]
                if h < w:
                    size = (self._size, int(w * self._size / h))
                else:
                    size = (int(h * self._size / w), self._size)
            else:
                size = (self._size, self._size)
        else:
            size = (self._size[1], self._size[0])
        return _host(_resize_np(a, size, self._interpolation))


def _crop(a, y, x, h, w):
    return a[y:y + h, x:x + w]


def _hw(size):
    return (size, size) if isinstance(size, int) else (size[1], size[0])


class CenterCrop(_Transform):
    """The centre crop of ``size`` ((w, h) or an int), resizing up first
    where the image is smaller."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = _hw(size)
        self._interpolation = interpolation

    def forward(self, x):
        a = _to_np(x)
        ch, cw = self._size
        h, w = a.shape[:2]
        if h < ch or w < cw:
            a = _resize_np(a, (max(h, ch), max(w, cw)), self._interpolation)
            h, w = a.shape[:2]
        return _host(_crop(a, (h - ch) // 2, (w - cw) // 2, ch, cw))


class RandomCrop(_Transform):
    """A random crop of ``size``, after zero padding of ``pad``."""

    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        self._size = _hw(size)
        self._pad = pad
        self._interpolation = interpolation

    def forward(self, x):
        a = _to_np(x)
        if self._pad:
            p = self._pad
            a = np.pad(a, ((p, p), (p, p)) + ((0, 0),) * (a.ndim - 2),
                       mode="constant")
        ch, cw = self._size
        h, w = a.shape[:2]
        if h < ch or w < cw:
            a = _resize_np(a, (max(h, ch), max(w, cw)), self._interpolation)
            h, w = a.shape[:2]
        y0 = np.random.randint(0, h - ch + 1)
        x0 = np.random.randint(0, w - cw + 1)
        return _host(_crop(a, y0, x0, ch, cw))


class RandomResizedCrop(_Transform):
    """A crop of random area (``scale``) and aspect (``ratio``), resized
    to ``size``; a centre crop after ten misses."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = _hw(size)
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def forward(self, x):
        a = _to_np(x)
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            aspect = np.random.uniform(*self._ratio)
            ch = int(round(np.sqrt(target_area / aspect)))
            cw = int(round(np.sqrt(target_area * aspect)))
            if ch <= h and cw <= w:
                y0 = np.random.randint(0, h - ch + 1)
                x0 = np.random.randint(0, w - cw + 1)
                return _host(_resize_np(_crop(a, y0, x0, ch, cw),
                                        self._size, self._interpolation))
        # the reference hands its (h, w) to CenterCrop, which reads (w, h)
        return CenterCrop(self._size, self._interpolation)(a)


class RandomFlipLeftRight(_Transform):
    def forward(self, x):
        a = _to_np(x)
        if np.random.rand() < 0.5:
            a = a[:, ::-1]
        return _host(a)


class RandomFlipTopBottom(_Transform):
    def forward(self, x):
        a = _to_np(x)
        if np.random.rand() < 0.5:
            a = a[::-1]
        return _host(a)


class RandomBrightness(_Transform):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        a = _to_np(x).astype(np.float32)
        f = 1.0 + np.random.uniform(-self._b, self._b)
        return _host(np.clip(a * f, 0, 255))


class RandomContrast(_Transform):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        a = _to_np(x).astype(np.float32)
        f = 1.0 + np.random.uniform(-self._c, self._c)
        gray = a.mean()
        return _host(np.clip(gray + (a - gray) * f, 0, 255))


class RandomSaturation(_Transform):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        a = _to_np(x).astype(np.float32)
        f = 1.0 + np.random.uniform(-self._s, self._s)
        gray = a.mean(axis=-1, keepdims=True)
        return _host(np.clip(gray + (a - gray) * f, 0, 255))


class RandomLighting(_Transform):
    """AlexNet's PCA lighting noise."""

    _eigval = np.array([55.46, 4.794, 1.148])
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]])

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        a = _to_np(x).astype(np.float32)
        alpha = np.random.normal(0, self._alpha, size=(3,))
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return _host(np.clip(a + rgb, 0, 255))


class RandomHue(_Transform):
    """Hue jitter: a rotation in YIQ space."""

    _to_yiq = np.array([[0.299, 0.587, 0.114],
                        [0.596, -0.274, -0.321],
                        [0.211, -0.523, 0.311]])
    _from_yiq = np.linalg.inv(_to_yiq)

    def __init__(self, hue):
        super().__init__()
        self._h = hue

    def forward(self, x):
        a = _to_np(x).astype(np.float32)
        theta = np.random.uniform(-self._h, self._h) * np.pi
        c, s = np.cos(theta), np.sin(theta)
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        m = self._from_yiq @ rot @ self._to_yiq
        return _host(np.clip(a @ m.T, 0, 255))


class RandomColorJitter(_Transform):
    """Brightness, contrast, saturation and hue jitters in a random
    order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))
        if hue:
            self._ts.append(RandomHue(hue))

    def forward(self, x):
        for i in np.random.permutation(len(self._ts)):
            x = self._ts[i](x)
        return x

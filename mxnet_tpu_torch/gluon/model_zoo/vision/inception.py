"""Inception V3 (mirrors ``mxnet_tpu/gluon/model_zoo/vision/inception.py``),
its branches over ``HybridConcatenate``."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    setting_names = ["channels", "kernel_size", "strides", "padding"]
    for setting in conv_settings:
        kwargs = {}
        for i, value in enumerate(setting):
            if value is not None:
                kwargs[setting_names[i]] = value
        out.add(_make_basic_conv(**kwargs))
    return out


def _make_A(pool_features, prefix):
    out = nn.HybridConcatenate(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (64, 1, None, None)))
        out.add(_make_branch(None, (48, 1, None, None),
                             (64, 5, None, 2)))
        out.add(_make_branch(None, (64, 1, None, None),
                             (96, 3, None, 1), (96, 3, None, 1)))
        out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B(prefix):
    out = nn.HybridConcatenate(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (384, 3, 2, None)))
        out.add(_make_branch(None, (64, 1, None, None),
                             (96, 3, None, 1), (96, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7, prefix):
    out = nn.HybridConcatenate(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None)))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0))))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (192, (1, 7), None, (0, 3))))
        out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D(prefix):
    out = nn.HybridConcatenate(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None),
                             (320, 3, 2, None)))
        out.add(_make_branch(None, (192, 1, None, None),
                             (192, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0)),
                             (192, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


class _InceptionE(HybridBlock):
    """E block with nested concats."""

    def __init__(self, prefix=None, **kwargs):
        super().__init__(prefix=prefix, **kwargs)
        with self.name_scope():
            self.b0 = _make_branch(None, (320, 1, None, None))
            self.b1_stem = _make_basic_conv(channels=384, kernel_size=1)
            self.b1a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                        padding=(0, 1))
            self.b1b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                        padding=(1, 0))
            self.b2_stem = nn.HybridSequential(prefix="")
            self.b2_stem.add(_make_basic_conv(channels=448, kernel_size=1))
            self.b2_stem.add(_make_basic_conv(channels=384, kernel_size=3,
                                              padding=1))
            self.b2a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                        padding=(0, 1))
            self.b2b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                        padding=(1, 0))
            self.b3 = _make_branch("avg", (192, 1, None, None))

    def hybrid_forward(self, F, x):
        o0 = self.b0(x)
        s1 = self.b1_stem(x)
        o1 = F.concat(self.b1a(s1), self.b1b(s1), dim=1)
        s2 = self.b2_stem(x)
        o2 = F.concat(self.b2a(s2), self.b2b(s2), dim=1)
        o3 = self.b3(x)
        return F.concat(o0, o1, o2, o3, dim=1)


class Inception3(HybridBlock):
    """Inception v3."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                               strides=2))
            self.features.add(_make_basic_conv(channels=32, kernel_size=3))
            self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                               padding=1))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80, kernel_size=1))
            self.features.add(_make_basic_conv(channels=192, kernel_size=3))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_InceptionE(prefix="E1_"))
            self.features.add(_InceptionE(prefix="E2_"))
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = F.Flatten(x)
        return self.output(x)


def inception_v3(pretrained=False, ctx=None, **kwargs):
    from ._common import load_pretrained
    pf = kwargs.pop("params_file", None)
    return load_pretrained(Inception3(**kwargs), pretrained, pf, ctx)

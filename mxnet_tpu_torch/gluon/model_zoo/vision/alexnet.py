"""AlexNet (mirrors ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``)."""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import (Conv2D, Dense, Dropout, Flatten, HybridSequential,
                   MaxPool2D)

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    """AlexNet."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            with self.features.name_scope():
                self.features.add(Conv2D(64, kernel_size=11, strides=4,
                                         padding=2, activation="relu"))
                self.features.add(MaxPool2D(pool_size=3, strides=2))
                self.features.add(Conv2D(192, kernel_size=5, padding=2,
                                         activation="relu"))
                self.features.add(MaxPool2D(pool_size=3, strides=2))
                self.features.add(Conv2D(384, kernel_size=3, padding=1,
                                         activation="relu"))
                self.features.add(Conv2D(256, kernel_size=3, padding=1,
                                         activation="relu"))
                self.features.add(Conv2D(256, kernel_size=3, padding=1,
                                         activation="relu"))
                self.features.add(MaxPool2D(pool_size=3, strides=2))
                self.features.add(Flatten())
                self.features.add(Dense(4096, activation="relu"))
                self.features.add(Dropout(0.5))
                self.features.add(Dense(4096, activation="relu"))
                self.features.add(Dropout(0.5))
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


def alexnet(pretrained=False, ctx=None, **kwargs):
    from ._common import load_pretrained
    pf = kwargs.pop("params_file", None)
    return load_pretrained(AlexNet(**kwargs), pretrained, pf, ctx)

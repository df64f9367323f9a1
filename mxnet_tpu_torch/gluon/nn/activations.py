"""Activation layers of the port (mirrors
``mxnet_tpu/gluon/nn/activations.py``): ``LeakyReLU``, ``PReLU``,
``ELU``, ``SELU``, ``Swish``, ``GELU``, over the registry's
``LeakyReLU`` op."""
from __future__ import annotations

from ... import initializer
from ..block import HybridBlock

__all__ = ["LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU"]


class LeakyReLU(HybridBlock):
    """``max(alpha * x, x)``."""

    def __init__(self, alpha, **kwargs):
        if alpha < 0:
            raise AssertionError("Slope coefficient for LeakyReLU must be "
                                 ">= 0.")
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return f"LeakyReLU({self._alpha})"


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope per channel (axis 1), 0.25 at
    start."""

    def __init__(self, alpha_initializer=None, in_channels=1, **kwargs):
        super().__init__(**kwargs)
        if alpha_initializer is None:
            alpha_initializer = initializer.Constant(0.25)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(in_channels,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha=None):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    """Exponential linear unit."""

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled exponential linear unit."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class GELU(HybridBlock):
    """Gaussian error linear unit (the exact erf form)."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")

"""Contributed gluon layers of the port (mirrors
``mxnet_tpu/gluon/contrib/nn/basic_layers.py``)."""
from __future__ import annotations

from .... import autograd
from ...nn.basic_layers import (BatchNorm, Embedding, HybridBlock,
                                HybridConcatenate, Concatenate)
from ...nn.basic_layers import Identity  # noqa: F401

__all__ = ["Concurrent", "HybridConcurrent", "Identity",
           "SparseEmbedding", "SyncBatchNorm", "PixelShuffle1D",
           "PixelShuffle2D", "PixelShuffle3D"]


class Concurrent(Concatenate):
    """Runs every child on the same input and concatenates the outputs
    along ``axis``."""


class HybridConcurrent(HybridConcatenate):
    """:class:`Concurrent` of hybrid blocks."""


class SparseEmbedding(Embedding):
    """``Embedding`` whose weight gradient is row-sparse (the reference's
    contrib name for ``nn.Embedding(sparse_grad=True)``)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(input_dim, output_dim, dtype=dtype,
                         weight_initializer=weight_initializer,
                         sparse_grad=True, **kwargs)

    def __repr__(self):
        return "Sparse" + super().__repr__()


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm over axis 1, through the registry's
    ``_contrib_SyncBatchNorm``. On one device (no ``axis_name``) it is
    ``BatchNorm``; the moments averaged over the devices of a mesh axis
    (``axis_name``) need the collectives of ROADMAP.md §1 item 9."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", axis_name=None,
                 **kwargs):
        if axis_name is not None:
            raise NotImplementedError(
                f"SyncBatchNorm(axis_name={axis_name!r}) averages moments "
                "across devices, which needs the port's collectives "
                "(ROADMAP.md §1 item 9); without axis_name it is "
                "BatchNorm")
        super().__init__(
            axis=1, momentum=momentum, epsilon=epsilon, center=center,
            scale=scale, use_global_stats=use_global_stats,
            beta_initializer=beta_initializer,
            gamma_initializer=gamma_initializer,
            running_mean_initializer=running_mean_initializer,
            running_variance_initializer=running_variance_initializer,
            in_channels=in_channels, **kwargs)

    def hybrid_forward(self, F, x, gamma=None, beta=None,
                       running_mean=None, running_var=None):
        if autograd.is_training() and not self._use_global_stats:
            out, mean, var = F._contrib_SyncBatchNorm(
                x, gamma, beta, running_mean, running_var,
                output_mean_var=True, **self._kwargs)
            with autograd.pause():
                m = self._momentum
                self.running_mean.set_data(running_mean * m
                                           + mean * (1 - m))
                self.running_var.set_data(running_var * m + var * (1 - m))
            return out
        return F._contrib_SyncBatchNorm(x, gamma, beta, running_mean,
                                        running_var, **self._kwargs)


class _PixelShuffle(HybridBlock):
    _ndim = 0

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        self._factors = ((factor,) * self._ndim if isinstance(factor, int)
                         else tuple(factor))
        if len(self._factors) != self._ndim:
            raise ValueError(f"{type(self).__name__} takes {self._ndim} "
                             f"factors, got {factor}")

    def __repr__(self):
        return f"{type(self).__name__}({self._factors})"

    def hybrid_forward(self, F, x):
        # (N, C*f1*...*fk, d1, ..., dk) -> (N, C, d1*f1, ..., dk*fk)
        k = self._ndim
        n, cf = x.shape[:2]
        dims = x.shape[2:]
        c = cf
        for f in self._factors:
            c //= f
        x = x.reshape((n, c) + self._factors + tuple(dims))
        order = [0, 1]
        for i in range(k):
            order += [2 + k + i, 2 + i]
        x = x.permute(*order)
        return x.reshape((n, c) + tuple(d * f for d, f in
                                        zip(dims, self._factors)))


class PixelShuffle1D(_PixelShuffle):
    """``(N, C*f, W) -> (N, C, W*f)``."""
    _ndim = 1


class PixelShuffle2D(_PixelShuffle):
    """``(N, C*fh*fw, H, W) -> (N, C, H*fh, W*fw)``."""
    _ndim = 2


class PixelShuffle3D(_PixelShuffle):
    """``(N, C*f1*f2*f3, D, H, W) -> (N, C, D*f1, H*f2, W*f3)``."""
    _ndim = 3

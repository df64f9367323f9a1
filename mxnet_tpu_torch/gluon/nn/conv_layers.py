"""Convolution and pooling layers of the port (mirrors
``mxnet_tpu/gluon/nn/conv_layers.py``): ``Conv1D/2D/3D``, their
transposes, the max, average and global pools in 1-3 dimensions, and
``ReflectionPad2D``.

The data layout is the layer's ``layout`` (``NCHW`` by default,
``NHWC`` channels-last); the weight's is the data layout with N→O and
C→I for a convolution (``OIHW`` / ``OHWI``) and N→I, C→O for a
transposed one, as the JAX package stores them, so parameter files move
between the packages. A deferred input-channel count comes from the
layout's ``C`` axis of the first input. The ops are the registry's
``Convolution``, ``Deconvolution`` and ``Pooling``
(:mod:`mxnet_tpu_torch.ops.nn`).
"""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]


def _tup(v, n):
    if v is None:
        return (1,) * n
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,) * n


class _Conv(HybridBlock):
    """A convolution (``op_name="Convolution"``) or transposed convolution
    (``"Deconvolution"``, ``adj`` its output padding) with an optional
    activation."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution",
                 adj=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._in_channels = in_channels
        self._layout = layout
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = adj
        self._op_name = op_name
        self._groups = groups
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=self._weight_shape(in_channels),
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def _weight_shape(self, in_ch):
        """The data layout with N→O, C→I (a transposed convolution: N→I,
        C→O): ``OIHW`` for ``NCHW``, ``OHWI`` for ``NHWC``."""
        kernel = tuple(self._kwargs["kernel"])
        channels_last = self._layout and self._layout[-1] == "C"
        if self._op_name == "Convolution":
            o, i = self._channels, (in_ch // self._groups if in_ch else 0)
        else:
            o, i = in_ch, self._channels // self._groups
        return (o,) + kernel + (i,) if channels_last else (o, i) + kernel

    def _infer_param_shapes(self, x, *args):
        in_ch = x.shape[self._layout.index("C") if self._layout else 1]
        self.weight.shape = self._weight_shape(in_ch)
        self._in_channels = in_ch

    def hybrid_forward(self, F, x, weight=None, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            act = op(x, weight, **self._kwargs)
        else:
            act = op(x, weight, bias, **self._kwargs)
        if self.act is not None:
            act = self.act(act)
        return act

    def __repr__(self):
        s = "{name}({mapping}, kernel_size={kernel}, stride={stride}"
        n = len(self._kwargs["kernel"])
        if self._kwargs["pad"] != (0,) * n:
            s += ", padding={pad}"
        if self._kwargs["dilate"] != (1,) * n:
            s += ", dilation={dilate}"
        if self._groups != 1:
            s += f", groups={self._groups}"
        if self.bias is None:
            s += ", bias=False"
        if self.act:
            s += f", {self.act}"
        s += ")"
        shape = self.weight.shape
        channels_last = self._layout and self._layout[-1] == "C"
        in_ch = shape[-1] if channels_last else shape[1]
        return s.format(name=self.__class__.__name__,
                        mapping=f"{in_ch if in_ch else None} -> {shape[0]}",
                        **self._kwargs)


class Conv1D(_Conv):
    """1-D convolution."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(
            channels, _tup(kernel_size, 1), _tup(strides, 1),
            _tup(padding, 1), _tup(dilation, 1), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, **kwargs)


class Conv2D(_Conv):
    """2-D convolution."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(
            channels, _tup(kernel_size, 2), _tup(strides, 2),
            _tup(padding, 2), _tup(dilation, 2), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, **kwargs)


class Conv3D(_Conv):
    """3-D convolution."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(
            channels, _tup(kernel_size, 3), _tup(strides, 3),
            _tup(padding, 3), _tup(dilation, 3), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    """1-D transposed convolution."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(
            channels, _tup(kernel_size, 1), _tup(strides, 1),
            _tup(padding, 1), _tup(dilation, 1), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, op_name="Deconvolution",
            adj=_tup(output_padding, 1), **kwargs)


class Conv2DTranspose(_Conv):
    """2-D transposed convolution."""

    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), dilation=(1, 1),
                 groups=1, layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(
            channels, _tup(kernel_size, 2), _tup(strides, 2),
            _tup(padding, 2), _tup(dilation, 2), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, op_name="Deconvolution",
            adj=_tup(output_padding, 2), **kwargs)


class Conv3DTranspose(_Conv):
    """3-D transposed convolution."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(
            channels, _tup(kernel_size, 3), _tup(strides, 3),
            _tup(padding, 3), _tup(dilation, 3), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, op_name="Deconvolution",
            adj=_tup(output_padding, 3), **kwargs)


class _Pooling(HybridBlock):
    """A pooling layer over the layout's spatial axes (``ceil_mode``:
    the reference's ``full`` convention)."""

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", layout=None,
                 count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
            "layout": layout}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return ("{name}(size={kernel}, stride={stride}, padding={pad}, "
                "ceil_mode={ceil_mode})".format(
                    name=self.__class__.__name__,
                    ceil_mode=self._kwargs["pooling_convention"] == "full",
                    **self._kwargs))


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(
            _tup(pool_size, 1), strides if strides is None
            else _tup(strides, 1), _tup(padding, 1), ceil_mode, False,
            "max", layout, **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(
            _tup(pool_size, 2), strides if strides is None
            else _tup(strides, 2), _tup(padding, 2), ceil_mode, False,
            "max", layout, **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(
            _tup(pool_size, 3), strides if strides is None
            else _tup(strides, 3), _tup(padding, 3), ceil_mode, False,
            "max", layout, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(
            _tup(pool_size, 1), strides if strides is None
            else _tup(strides, 1), _tup(padding, 1), ceil_mode, False,
            "avg", layout, count_include_pad, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(
            _tup(pool_size, 2), strides if strides is None
            else _tup(strides, 2), _tup(padding, 2), ceil_mode, False,
            "avg", layout, count_include_pad, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(
            _tup(pool_size, 3), strides if strides is None
            else _tup(strides, 3), _tup(padding, 3), ceil_mode, False,
            "avg", layout, count_include_pad, **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "max", layout,
                         **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "max", layout,
                         **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "max",
                         layout, **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "avg", layout,
                         **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg", layout,
                         **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "avg",
                         layout, **kwargs)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of H and W (an int: ``padding`` on each side)."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)

"""Convolutional recurrent cells of the port (mirrors
``mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py``): the RNN, LSTM and GRU
cells in 1, 2 and 3 spatial dimensions, their input-to-hidden and
hidden-to-hidden maps convolutions of stride 1 padded to keep the
spatial size. ``input_shape`` is one step's input ``(C, *spatial)``;
states are ``(batch, hidden_channels, *spatial)``."""
from __future__ import annotations

import torch

from ...rnn.rnn_cell import HybridRecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _BaseConvCell(HybridRecurrentCell):
    _n_states = 1
    _gates = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, ndim, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_shape = tuple(input_shape)
        self._channels = hidden_channels
        self._ndim = ndim
        self._activation = activation
        self._i2h_kernel = _tup(i2h_kernel, ndim)
        self._h2h_kernel = _tup(h2h_kernel, ndim)
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise ValueError("the h2h kernel must be odd, for states of "
                             f"the input's size: got {self._h2h_kernel}")
        self._i2h_pad = tuple(k // 2 for k in self._i2h_kernel)
        self._h2h_pad = tuple(k // 2 for k in self._h2h_kernel)
        g = self._gates * hidden_channels
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(g, input_shape[0]) + self._i2h_kernel,
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(g, hidden_channels) + self._h2h_kernel,
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(g,), init=i2h_bias_initializer,
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(g,), init=h2h_bias_initializer,
                allow_deferred_init=True)

    def state_info(self, batch_size=0):
        shape = (batch_size, self._channels) + self._input_shape[1:]
        return [{"shape": shape, "__layout__": "NC" + "DHW"[-self._ndim:]}
                ] * self._n_states

    def _conv_pre(self, F, x, h, i2h_weight, h2h_weight, i2h_bias,
                  h2h_bias):
        n = self._gates * self._channels
        one = (1,) * self._ndim
        return (F.Convolution(x, i2h_weight, i2h_bias,
                              kernel=self._i2h_kernel, stride=one,
                              pad=self._i2h_pad, num_filter=n),
                F.Convolution(h, h2h_weight, h2h_bias,
                              kernel=self._h2h_kernel, stride=one,
                              pad=self._h2h_pad, num_filter=n))


class _ConvRNNCell(_BaseConvCell):
    def hybrid_forward(self, F, x, states, i2h_weight=None,
                       h2h_weight=None, i2h_bias=None, h2h_bias=None):
        i2h, h2h = self._conv_pre(F, x, states[0], i2h_weight, h2h_weight,
                                  i2h_bias, h2h_bias)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class _ConvLSTMCell(_BaseConvCell):
    _n_states = 2
    _gates = 4

    def hybrid_forward(self, F, x, states, i2h_weight=None,
                       h2h_weight=None, i2h_bias=None, h2h_bias=None):
        i2h, h2h = self._conv_pre(F, x, states[0], i2h_weight, h2h_weight,
                                  i2h_bias, h2h_bias)
        i, f, g, o = torch.chunk(i2h + h2h, 4, dim=1)
        g = F.Activation(g, act_type=self._activation)
        c = torch.sigmoid(f) * states[1] + torch.sigmoid(i) * g
        out = torch.sigmoid(o) * F.Activation(c, act_type=self._activation)
        return out, [out, c]


class _ConvGRUCell(_BaseConvCell):
    _gates = 3

    def hybrid_forward(self, F, x, states, i2h_weight=None,
                       h2h_weight=None, i2h_bias=None, h2h_bias=None):
        i2h, h2h = self._conv_pre(F, x, states[0], i2h_weight, h2h_weight,
                                  i2h_bias, h2h_bias)
        xr, xz, xn = torch.chunk(i2h, 3, dim=1)
        hr, hz, hn = torch.chunk(h2h, 3, dim=1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = F.Activation(xn + r * hn, act_type=self._activation)
        out = (1 - z) * n + z * states[0]
        return out, [out]


def _make(base, ndim, name, doc):
    def __init__(self, input_shape, hidden_channels, i2h_kernel=3,
                 h2h_kernel=3, **kwargs):
        base.__init__(self, input_shape, hidden_channels, i2h_kernel,
                      h2h_kernel, ndim=ndim, **kwargs)
    return type(name, (base,), {"__init__": __init__, "__doc__": doc,
                                "__module__": __name__})


Conv1DRNNCell = _make(_ConvRNNCell, 1, "Conv1DRNNCell",
                      "1-D convolutional Elman cell.")
Conv2DRNNCell = _make(_ConvRNNCell, 2, "Conv2DRNNCell",
                      "2-D convolutional Elman cell.")
Conv3DRNNCell = _make(_ConvRNNCell, 3, "Conv3DRNNCell",
                      "3-D convolutional Elman cell.")
Conv1DLSTMCell = _make(_ConvLSTMCell, 1, "Conv1DLSTMCell",
                       "1-D ConvLSTM cell (Shi et al., 2015).")
Conv2DLSTMCell = _make(_ConvLSTMCell, 2, "Conv2DLSTMCell",
                       "2-D ConvLSTM cell (Shi et al., 2015).")
Conv3DLSTMCell = _make(_ConvLSTMCell, 3, "Conv3DLSTMCell",
                       "3-D ConvLSTM cell.")
Conv1DGRUCell = _make(_ConvGRUCell, 1, "Conv1DGRUCell",
                      "1-D convolutional GRU cell.")
Conv2DGRUCell = _make(_ConvGRUCell, 2, "Conv2DGRUCell",
                      "2-D convolutional GRU cell.")
Conv3DGRUCell = _make(_ConvGRUCell, 3, "Conv3DGRUCell",
                      "3-D convolutional GRU cell.")

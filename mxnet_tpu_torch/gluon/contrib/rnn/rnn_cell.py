"""Contributed recurrent cells of the port (mirrors
``mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``): ``VariationalDropoutCell``
and ``LSTMPCell``."""
from __future__ import annotations

import torch

from .... import autograd
from ...rnn.rnn_cell import HybridRecurrentCell, ModifierCell, _drop_mask

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(ModifierCell):
    """Variational dropout around a base cell (Gal & Ghahramani, 2016):
    in training mode one mask for the inputs, one for the first state and
    one for the outputs, drawn at the first step of a sequence and reused
    at every step until ``reset()`` (``unroll`` resets). The masks are
    host state between steps, so the cell dispatches in ``forward`` and
    ``hybridize()`` never captures it as a whole."""

    _dispatches_in_forward = True

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._masks = {}

    def reset(self):
        super().reset()
        self._masks = {}

    def _dropout(self, x, rate, which):
        if rate == 0.0 or not autograd.is_training():
            return x
        mask = self._masks.get(which)
        if mask is None or mask.shape != x.shape:
            mask = _drop_mask(x, rate).to(x.dtype) / (1.0 - rate)
            self._masks[which] = mask
        return x * mask

    def forward(self, x, states):
        x = self._dropout(x, self.drop_inputs, "inputs")
        if self.drop_states:
            states = [self._dropout(states[0], self.drop_states,
                                    "states")] + list(states[1:])
        out, next_states = self.base_cell(x, states)
        return self._dropout(out, self.drop_outputs, "outputs"), next_states

    def __repr__(self):
        return (f"VariationalDropoutCell(in={self.drop_inputs}, "
                f"state={self.drop_states}, out={self.drop_outputs}, "
                f"base={self.base_cell!r})")


class LSTMPCell(HybridRecurrentCell):
    """LSTM with a projected recurrent state (Sak et al., 2014): ``r = P
    (o * tanh(c))`` with ``P`` (projection_size, hidden_size), and ``r``
    fed back in place of ``h``."""

    def __init__(self, hidden_size, projection_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        g = 4 * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(g, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(g, projection_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.h2r_weight = self.params.get(
                "h2r_weight", shape=(projection_size, hidden_size),
                init=h2r_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(g,), init=i2h_bias_initializer,
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(g,), init=h2h_bias_initializer,
                allow_deferred_init=True)

    def _infer_param_shapes(self, x, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def hybrid_forward(self, F, x, states, i2h_weight=None,
                       h2h_weight=None, h2r_weight=None, i2h_bias=None,
                       h2h_bias=None):
        gates = (F.FullyConnected(x, i2h_weight, i2h_bias)
                 + F.FullyConnected(states[0], h2h_weight, h2h_bias))
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f) * states[1] + torch.sigmoid(i) * torch.tanh(g)
        hidden = torch.sigmoid(o) * torch.tanh(c)
        r = F.FullyConnected(hidden, h2r_weight)
        return r, [r, c]

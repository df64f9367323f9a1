"""Fused recurrent layers of the port (mirrors
``mxnet_tpu/gluon/rnn/rnn_layer.py``): ``RNN``, ``LSTM`` and ``GRU`` over
the registry's fused ``RNN`` op (``ops/rnn.py``).

Parameters are held per layer and direction under the reference's names
(``{l,r}{i}_{i2h,h2h}_{weight,bias}``) and packed into the op's flat
vector at each call in the reference's order: every weight, layer-major
and direction-minor, then every bias. So a JAX layer's parameters carry
across by name and shape unchanged. States are returned only when they
were passed, and are made on the input's device when they were not.
"""
from __future__ import annotations

import torch

from ..block import HybridBlock
from .rnn_cell import _zeros_state

__all__ = ["RNN", "LSTM", "GRU"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


class _RNNLayer(HybridBlock):
    def __init__(self, mode, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size=0, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if layout not in ("TNC", "NTC"):
            raise ValueError(f"Invalid layout {layout}; must be TNC or NTC")
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = _GATES[mode]
        g = self._gates * hidden_size
        with self.name_scope():
            for layer in range(num_layers):
                in_sz = input_size if layer == 0 else \
                    hidden_size * self._dir
                for tag in ["l", "r"][:self._dir]:
                    for name, shape, init in (
                            ("i2h_weight", (g, in_sz),
                             i2h_weight_initializer),
                            ("h2h_weight", (g, hidden_size),
                             h2h_weight_initializer),
                            ("i2h_bias", (g,), i2h_bias_initializer),
                            ("h2h_bias", (g,), h2h_bias_initializer)):
                        full = f"{tag}{layer}_{name}"
                        setattr(self, full, self.params.get(
                            full, shape=shape, init=init,
                            allow_deferred_init=True))

    def __repr__(self):
        return (f"{type(self).__name__}({self._input_size or None} -> "
                f"{self._hidden_size}, {self._layout}, "
                f"num_layers={self._num_layers}"
                f"{', bidirectional' if self._dir == 2 else ''})")

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size,
                 self._hidden_size)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": shape, "__layout__": "LNC"}] * n

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states (``(layers * directions, batch, hidden)``) on
        ``ctx``/``device`` (default: the innermost ``with Context``
        block's, else the card), or ``func(shape=..., **kwargs)``."""
        return [_zeros_state(info["shape"], func, **kwargs)
                for info in self.state_info(batch_size)]

    def _infer_param_shapes(self, x, *args):
        in_sz = x.shape[-1]
        g = self._gates * self._hidden_size
        for tag in ["l", "r"][:self._dir]:
            getattr(self, f"{tag}0_i2h_weight").shape = (g, in_sz)

    def _flat_params(self, kwargs):
        """The fused op's flat vector: weights, layer-major and
        direction-minor, then biases in the same order."""
        tags = ["l", "r"][:self._dir]
        chunks = [kwargs[f"{tag}{layer}_{kind}_weight"].reshape(-1)
                  for layer in range(self._num_layers) for tag in tags
                  for kind in ("i2h", "h2h")]
        chunks += [kwargs[f"{tag}{layer}_{kind}_bias"]
                   for layer in range(self._num_layers) for tag in tags
                   for kind in ("i2h", "h2h")]
        return torch.cat(chunks)

    def hybrid_forward(self, F, x, *args, **kwargs):
        states = args[0] if args else None
        skip_states = states is None
        if skip_states:
            batch = x.shape[0] if self._layout == "NTC" else x.shape[1]
            states = self.begin_state(batch, device=x.device, dtype=x.dtype)
        if not isinstance(states, (list, tuple)):
            states = [states]
        if self._layout == "NTC":
            x = x.transpose(0, 1)
        inputs = [x, self._flat_params(kwargs), states[0]]
        if self._mode == "lstm":
            inputs.append(states[1])
        out, h_t, c_t = F.RNN(*inputs, state_size=self._hidden_size,
                              num_layers=self._num_layers, mode=self._mode,
                              bidirectional=self._dir == 2, p=self._dropout,
                              state_outputs=True)
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        if skip_states:
            return out
        return out, ([h_t, c_t] if self._mode == "lstm" else [h_t])


class RNN(_RNNLayer):
    """Multi-layer Elman RNN, ``relu`` or ``tanh``."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 input_size=0, **kwargs):
        super().__init__(f"rnn_{activation}", hidden_size, num_layers,
                         layout, dropout, bidirectional,
                         input_size=input_size, **kwargs)


class LSTM(_RNNLayer):
    """Multi-layer LSTM."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size=input_size, **kwargs)


class GRU(_RNNLayer):
    """Multi-layer GRU."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("gru", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size=input_size, **kwargs)

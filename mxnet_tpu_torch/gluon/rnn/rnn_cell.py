"""Recurrent cells of the port (mirrors
``mxnet_tpu/gluon/rnn/rnn_cell.py``): one step a call, and ``unroll``
over a sequence in either layout.

Parameter names and gate orders are the reference's (``i2h_weight``,
``h2h_weight``, ``i2h_bias``, ``h2h_bias``; LSTM [i, f, g, o], GRU [r, z,
n]), so ``convert.load_gluon_params`` carries a JAX cell's parameters
across as they are. States are made on the input's device (or ``ctx=``),
never on the CPU by default. The cells that dispatch in ``forward``
(``SequentialRNNCell``, ``ZoneoutCell``, ``BidirectionalCell``) keep
state on the host between steps, so ``hybridize()`` never captures them
as a whole: their children are captured one by one. Dropout masks draw
from the port's generator (``_rng.next_generator``), a compiled region's
own inside one.
"""
from __future__ import annotations

import torch

from ... import _rng, autograd
from ..._device import resolve_device
from ...base import torch_dtype
from ...ndarray.ndarray import unwrap
from ..block import Block, HybridBlock, _F

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout):
    """``inputs`` (a tensor in ``layout`` or a list of (N, C) steps) as
    a list of steps; returns (steps, time axis, batch size)."""
    if layout not in ("TNC", "NTC"):
        raise ValueError(f"layout must be TNC or NTC, got {layout}")
    axis = layout.find("T")
    if isinstance(inputs, (list, tuple)):
        steps = list(unwrap(inputs))
    else:
        inputs = unwrap(inputs)
        if axis == 1:
            inputs = inputs.transpose(0, 1)
        length = length or inputs.shape[0]
        steps = [inputs[t] for t in range(length)]
    return steps, axis, steps[0].shape[0]


def _merge_outputs(outputs, axis):
    stacked = torch.stack(list(outputs), dim=0)
    return stacked.transpose(0, 1) if axis == 1 else stacked


def _drop_mask(like, rate):
    """A keep mask of ``like``'s shape: each entry kept with probability
    ``1 - rate``, drawn from the port's generator."""
    gen = _rng.next_generator(like.device)
    return torch.rand(like.shape, generator=gen, device=like.device) >= rate


def _zeros_state(shape, func=None, ctx=None, device=None, dtype=None,
                 **kwargs):
    if func is not None:
        if ctx is not None or device is not None:
            kwargs["ctx"] = device if ctx is None else ctx
        if dtype is not None:
            kwargs["dtype"] = dtype
        return unwrap(func(shape=shape, **kwargs))
    dev = resolve_device(device if device is not None else ctx)
    return torch.zeros(shape, device=dev,
                       dtype=torch.float32 if dtype is None
                       else torch_dtype(dtype))


class RecurrentCell(HybridBlock):
    """Base recurrent cell: ``(input_t, states) -> (output_t,
    new_states)``."""

    # cells that keep host state between steps dispatch in forward() and
    # are never captured as a whole by hybridize()
    _dispatches_in_forward = False

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def _forward_call(self):
        if self._dispatches_in_forward:
            return Block._forward_call(self)
        return super()._forward_call()

    def reset(self):
        """Reset the step counters (and any per-sequence state) before a
        new sequence."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._children_blocks():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states: zeros of :meth:`state_info`'s shapes on
        ``ctx``/``device`` (default: the innermost ``with Context``
        block's, else the card) in ``dtype``, or ``func(shape=...,
        **kwargs)`` (``nd.zeros``, ``nd.random.uniform`` ...)."""
        if self._modified:
            raise RuntimeError(
                "After applying modifier cells the base cell cannot be "
                "called directly. Call the modifier cell instead.")
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            states.append(_zeros_state(info["shape"], func, **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run ``length`` steps over ``inputs``. Returns (outputs,
        states): the outputs merged into one tensor in ``layout`` unless
        ``merge_outputs`` is False (a list of steps). With
        ``valid_length`` (N,) the outputs past each sample's length are
        zero and the states are those of its last valid step."""
        self.reset()
        steps, axis, batch = _format_sequence(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch,
                                           device=steps[0].device,
                                           dtype=steps[0].dtype)
        states = unwrap(begin_state)
        valid_length = unwrap(valid_length)
        outputs, step_states = [], []
        for t in range(length):
            out, states = self(steps[t], states)
            outputs.append(out)
            if valid_length is not None:
                step_states.append(states)
        if valid_length is not None:
            masked = _F.SequenceMask(torch.stack(outputs, dim=0),
                                     valid_length, use_sequence_length=True)
            outputs = [masked[t] for t in range(length)]
            states = [
                _F.SequenceLast(torch.stack([s[i] for s in step_states]),
                                valid_length, use_sequence_length=True)
                for i in range(len(states))]
        if merge_outputs is None or merge_outputs:
            return _merge_outputs(outputs, axis), states
        return outputs, states

    def forward(self, x, *args):
        self._counter += 1
        return super().forward(x, *args)


class HybridRecurrentCell(RecurrentCell):
    """The reference's hybrid tier (every cell here is hybrid)."""


class _GatedCell(HybridRecurrentCell):
    """The parameter layout of the RNN, LSTM and GRU cells."""

    def __init__(self, hidden_size, gates, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._gates = gates
        g = gates * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(g, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(g, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(g,), init=i2h_bias_initializer,
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(g,), init=h2h_bias_initializer,
                allow_deferred_init=True)

    def _infer_param_shapes(self, x, *args):
        self.i2h_weight.shape = (self._gates * self._hidden_size,
                                 x.shape[-1])

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _projections(self, F, x, h, i2h_weight, h2h_weight, i2h_bias,
                     h2h_bias):
        return (F.FullyConnected(x, i2h_weight, i2h_bias),
                F.FullyConnected(h, h2h_weight, h2h_bias))


class RNNCell(_GatedCell):
    """Elman cell: ``h' = act(W_x x + b_x + W_h h + b_h)``."""

    def __init__(self, hidden_size, activation="tanh", **kwargs):
        super().__init__(hidden_size, gates=1, **kwargs)
        self._activation = activation

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, x, states, i2h_weight=None, h2h_weight=None,
                       i2h_bias=None, h2h_bias=None):
        xp, hp = self._projections(F, x, states[0], i2h_weight, h2h_weight,
                                   i2h_bias, h2h_bias)
        out = F.Activation(xp + hp, act_type=self._activation)
        return out, [out]


class LSTMCell(_GatedCell):
    """LSTM cell, gate order [i, f, g, o]."""

    def __init__(self, hidden_size, **kwargs):
        super().__init__(hidden_size, gates=4, **kwargs)

    def _alias(self):
        return "lstm"

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}] * 2

    def hybrid_forward(self, F, x, states, i2h_weight=None, h2h_weight=None,
                       i2h_bias=None, h2h_bias=None):
        xp, hp = self._projections(F, x, states[0], i2h_weight, h2h_weight,
                                   i2h_bias, h2h_bias)
        i, f, g, o = torch.chunk(xp + hp, 4, dim=-1)
        c = torch.sigmoid(f) * states[1] + torch.sigmoid(i) * torch.tanh(g)
        out = torch.sigmoid(o) * torch.tanh(c)
        return out, [out, c]


class GRUCell(_GatedCell):
    """GRU cell, gate order [r, z, n]: ``n = tanh(x_n + r * h_n)``."""

    def __init__(self, hidden_size, **kwargs):
        super().__init__(hidden_size, gates=3, **kwargs)

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, x, states, i2h_weight=None, h2h_weight=None,
                       i2h_bias=None, h2h_bias=None):
        xp, hp = self._projections(F, x, states[0], i2h_weight, h2h_weight,
                                   i2h_bias, h2h_bias)
        xr, xz, xn = torch.chunk(xp, 3, dim=-1)
        hr, hz, hn = torch.chunk(hp, 3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        out = (1 - z) * n + z * states[0]
        return out, [out]


class SequentialRNNCell(RecurrentCell):
    """Cells applied in turn at each step, each on its share of the
    states."""

    _dispatches_in_forward = True

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children_blocks(), batch_size)

    def begin_state(self, **kwargs):
        if self._modified:
            raise RuntimeError("a modified cell is called through its "
                               "modifier")
        return _cells_begin_state(self._children_blocks(), **kwargs)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return self._children_blocks()[i]

    def forward(self, x, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children_blocks():
            n = len(cell.state_info())
            x, s = cell(x, states[p:p + n])
            p += n
            next_states.extend(s)
        return x, next_states


HybridSequentialRNNCell = SequentialRNNCell


class DropoutCell(RecurrentCell):
    """Dropout of the input at each step (in training mode)."""

    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, x, states):
        if self._rate > 0 and autograd.is_training():
            keep = _drop_mask(x, self._rate)
            x = torch.where(keep, x / (1.0 - self._rate),
                            torch.zeros((), dtype=x.dtype, device=x.device))
        return x, states


class ModifierCell(RecurrentCell):
    """Base of the cells that wrap another cell (``base_cell``), whose
    parameters they share."""

    def __init__(self, base_cell):
        super().__init__(prefix=base_cell.prefix + "mod_")
        base_cell._modified = True
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        if self._modified:
            raise RuntimeError("a modified cell is called through its "
                               "modifier")
        self.base_cell._modified = False
        try:
            return self.base_cell.begin_state(func=func, **kwargs)
        finally:
            self.base_cell._modified = True


class ZoneoutCell(ModifierCell):
    """Zoneout: in training mode each output (state) entry keeps the
    previous step's value with probability ``zoneout_outputs``
    (``zoneout_states``)."""

    _dispatches_in_forward = True

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self._zo = zoneout_outputs
        self._zs = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def forward(self, x, states):
        out, next_states = self.base_cell(x, states)
        if autograd.is_training():
            if self._zo > 0:
                prev = self._prev_output
                if prev is None:
                    prev = torch.zeros_like(out)
                out = torch.where(_drop_mask(out, self._zo), out, prev)
            if self._zs > 0:
                next_states = [torch.where(_drop_mask(ns, self._zs), ns, s)
                               for ns, s in zip(next_states, states)]
        self._prev_output = out
        return out, next_states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def hybrid_forward(self, F, x, states):
        out, states = self.base_cell(x, states)
        return out + x, states


class BidirectionalCell(RecurrentCell):
    """Two cells over the sequence in opposite directions, their outputs
    concatenated; only through ``unroll``."""

    _dispatches_in_forward = True

    def __init__(self, l_cell, r_cell):
        super().__init__(prefix="bi_")
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children_blocks(), batch_size)

    def begin_state(self, **kwargs):
        if self._modified:
            raise RuntimeError("a modified cell is called through its "
                               "modifier")
        return _cells_begin_state(self._children_blocks(), **kwargs)

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell cannot be stepped; use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        steps, axis, batch = _format_sequence(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch,
                                           device=steps[0].device,
                                           dtype=steps[0].dtype)
        begin_state = unwrap(begin_state)
        valid_length = unwrap(valid_length)
        l_cell, r_cell = self._children_blocks()
        nl = len(l_cell.state_info())
        if valid_length is None:
            rev_steps = list(reversed(steps))
        else:
            # each sample reversed within its length: the padding stays
            # at the tail, so the reverse cell sees real tokens first
            rev = _F.SequenceReverse(torch.stack(steps), valid_length,
                                     use_sequence_length=True)
            rev_steps = [rev[t] for t in range(length)]
        l_out, l_states = l_cell.unroll(
            length, steps, begin_state[:nl], layout="TNC",
            merge_outputs=False, valid_length=valid_length)
        r_out, r_states = r_cell.unroll(
            length, rev_steps, begin_state[nl:], layout="TNC",
            merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            r_out = list(reversed(r_out))
        else:
            back = _F.SequenceReverse(torch.stack(r_out), valid_length,
                                      use_sequence_length=True)
            r_out = [back[t] for t in range(length)]
        outputs = [torch.cat([lo, ro], dim=-1)
                   for lo, ro in zip(l_out, r_out)]
        if merge_outputs in (None, True):
            return _merge_outputs(outputs, axis), l_states + r_states
        return outputs, l_states + r_states

"""Symbolic RNN cells — the legacy ``mx.rnn`` cell API (a copy of
``mxnet_tpu/rnn/rnn_cell.py``).

Reference: python/mxnet/rnn/rnn_cell.py (BaseRNNCell:107, RNNCell:361,
LSTMCell:407, GRUCell:468, FusedRNNCell:535, SequentialRNNCell:747,
DropoutCell:826, ResidualCell:956, BidirectionalCell:997). Cells build
Symbol graphs step by step; ``unroll`` lays the recurrence out as an
explicit chain of symbols sharing one parameter set.

An unrolled cell graph runs through the Symbol executor op by op;
``FusedRNNCell`` instead emits the single ``sym.RNN`` op (the port's
fused RNN op: one node whatever the sequence length). Gate orders
follow the cuDNN/reference convention (LSTM [i,f,g,o], GRU [r,z,n]) so
packed parameter vectors interchange with the fused op
(ops/rnn.py:14-20).

Conv*Cells and ZoneoutCell are not carried over (niche; gluon.contrib
has the modern equivalents).
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "DropoutCell",
           "ModifierCell", "ResidualCell", "BidirectionalCell"]


class RNNParams:
    """Container for cell parameters; shared when passed to several
    cells (reference: rnn_cell.py:77)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = sym.var(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """Abstract cell: one step per ``__call__`` (reference:
    rnn_cell.py:107)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in getattr(self, "_cells", ()):
            cell.reset()

    def __call__(self, inputs, states):
        raise NotImplementedError

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [e["shape"] for e in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, batch_size=0, **kwargs):
        """Initial states. With ``batch_size`` > 0 they are literal
        zero symbols (or ``func(shape=...)``); with the default 0 they
        are plain variables named ``<prefix>begin_state_<i>`` to be fed
        as data (shape (0, H) placeholders are meaningless where shapes
        are fixed at bind, so the reference's deferred-batch form maps to
        the feed-as-data idiom its own examples use)."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called"
        states = []
        for info in self.state_info:
            self._init_counter += 1
            shape = tuple(batch_size if d == 0 else d
                          for d in info["shape"])
            name = f"{self._prefix}begin_state_{self._init_counter}"
            if func is not None and not batch_size:
                # a (0, H) literal would be a real zero-row array (shapes
                # are fixed at bind) and break far downstream — fail
                # here with the remedy instead
                raise ValueError(
                    "begin_state(func=...) needs batch_size=<N> under "
                    "static shapes; either pass batch_size, or omit "
                    "func (states become named input variables), or "
                    "let unroll(begin_state=None) derive zero states "
                    "from the inputs")
            if func is not None or batch_size:
                make = func or sym.zeros
                states.append(make(shape=shape, name=name, **kwargs))
            else:
                states.append(sym.var(name, shape=None))
        return states

    def _zeros_like_states(self, step_input):
        """States of zeros whose batch dim is inherited from a step
        input symbol — keeps shapes static without knowing B."""
        out = []
        for info in self.state_info:
            width = info["shape"][-1]
            z = sym.mean(step_input * 0.0, axis=-1, keepdims=True)
            out.append(sym.tile(z, reps=(1, width)))
        return out

    def unpack_weights(self, args):
        """Split fused parameter blobs into per-gate arrays (reference:
        rnn_cell.py unpack_weights). Base cells store i2h/h2h blocks
        whole; only gate-splitting is performed."""
        args = dict(args)
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group in ("i2h", "h2h"):
            for kind in ("weight", "bias"):
                key = f"{self._prefix}{group}_{kind}"
                if key not in args:
                    continue
                blob = args.pop(key)
                for j, gate in enumerate(self._gate_names):
                    args[f"{self._prefix}{group}{gate}_{kind}"] = \
                        blob[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        args = dict(args)
        if not self._gate_names:
            return args
        from ..ndarray import concat as nd_concat
        for group in ("i2h", "h2h"):
            for kind in ("weight", "bias"):
                parts = []
                for gate in self._gate_names:
                    key = f"{self._prefix}{group}{gate}_{kind}"
                    if key in args:
                        parts.append(args.pop(key))
                if parts:
                    args[f"{self._prefix}{group}_{kind}"] = \
                        nd_concat(*parts, dim=0)
        return args

    def unroll(self, length, inputs=None, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll for ``length`` steps (reference: rnn_cell.py:262).

        inputs: one Symbol ((N,T,C) for NTC / (T,N,C) for TNC) or a list
        of per-step (N,C) symbols or None (creates ``t<i>_data`` vars).
        Returns (outputs, states): outputs merged into one symbol along
        the time axis when merge_outputs is True (or None and inputs
        came merged), else a list.
        """
        self.reset()
        axis = layout.find("T")
        came_merged = isinstance(inputs, sym.Symbol)
        if inputs is None:
            inputs = [sym.var(f"{self._prefix}t{i}_data")
                      for i in range(length)]
        elif came_merged:
            inputs = list(sym.split(inputs, num_outputs=length, axis=axis,
                                    squeeze_axis=1))
        assert len(inputs) == length
        if begin_state is None:
            states = self._zeros_like_states(inputs[0])
        else:
            states = list(begin_state)

        outputs = []
        for t in range(length):
            out, states = self(inputs[t], states)
            outputs.append(out)
        if merge_outputs is None:
            merge_outputs = came_merged
        if merge_outputs:
            outputs = sym.stack(*outputs, axis=axis)
        return outputs, states


class RNNCell(BaseRNNCell):
    """Elman cell: act(W_x x + W_h h + b) (reference: rnn_cell.py:361)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = sym.FullyConnected(inputs, self._iW, self._iB,
                                 num_hidden=self._num_hidden,
                                 name=f"{name}i2h")
        h2h = sym.FullyConnected(states[0], self._hW, self._hB,
                                 num_hidden=self._num_hidden,
                                 name=f"{name}h2h")
        output = sym.Activation(i2h + h2h, act_type=self._activation,
                                name=f"{name}out")
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell, gates [i, f, g, o] (reference: rnn_cell.py:407)."""

    def __init__(self, num_hidden, forget_bias=1.0, prefix="lstm_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        from .. import initializer as init_mod
        self._num_hidden = num_hidden
        self._forget_bias = forget_bias
        self._iW = self.params.get("i2h_weight")
        # forget_bias lives in the default i2h_bias initializer
        # (reference: rnn_cell.py:426 init.LSTMBias), NOT in the forward
        # pass — a forward-time add on top of checkpointed biases would
        # double-apply it and break fused/unfused and reference-trained
        # checkpoint agreement
        self._iB = self.params.get(
            "i2h_bias", init=init_mod.LSTMBias(forget_bias=forget_bias))
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        h, c = states
        gates = sym.FullyConnected(
            inputs, self._iW, self._iB, num_hidden=4 * self._num_hidden,
            name=f"{name}i2h") + sym.FullyConnected(
            h, self._hW, self._hB, num_hidden=4 * self._num_hidden,
            name=f"{name}h2h")
        i, f, g, o = sym.split(gates, num_outputs=4, axis=-1)
        i = sym.sigmoid(i)
        f = sym.sigmoid(f)
        g = sym.tanh(g)
        o = sym.sigmoid(o)
        next_c = f * c + i * g
        next_h = o * sym.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, gates [r, z, n] (reference: rnn_cell.py:468)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        prev = states[0]
        i2h = sym.FullyConnected(inputs, self._iW, self._iB,
                                 num_hidden=3 * self._num_hidden,
                                 name=f"{name}i2h")
        h2h = sym.FullyConnected(prev, self._hW, self._hB,
                                 num_hidden=3 * self._num_hidden,
                                 name=f"{name}h2h")
        i_r, i_z, i_n = sym.split(i2h, num_outputs=3, axis=-1)
        h_r, h_z, h_n = sym.split(h2h, num_outputs=3, axis=-1)
        r = sym.sigmoid(i_r + h_r)
        z = sym.sigmoid(i_z + h_z)
        n = sym.tanh(i_n + r * h_n)
        next_h = (1.0 - z) * n + z * prev
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """All layers/steps as ONE ``sym.RNN`` op — the lax.scan path
    (reference: rnn_cell.py:535, backed there by cuDNN)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, forget_bias=1.0,
                 get_next_state=False, prefix=None, params=None):
        if prefix is None:
            prefix = f"{mode}_"
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._forget_bias = forget_bias
        self._get_next_state = get_next_state
        from .. import initializer as init_mod
        # forget_bias reaches the packed vector through its default
        # initializer (reference: rnn_cell.py:563 init.FusedRNN); the op
        # itself never re-adds it
        self._parameters = self.params.get(
            "parameters",
            init=init_mod.FusedRNN(None, num_hidden=num_hidden,
                                   num_layers=num_layers, mode=mode,
                                   bidirectional=bidirectional,
                                   forget_bias=forget_bias))

    @property
    def state_info(self):
        d = 2 if self._bidirectional else 1
        n = [{"shape": (self._num_layers * d, 0, self._num_hidden),
              "__layout__": "LNC"}]
        if self._mode == "lstm":
            n.append({"shape": (self._num_layers * d, 0, self._num_hidden),
                      "__layout__": "LNC"})
        return n

    @property
    def _gate_names(self):
        return {"rnn_relu": ("",), "rnn_tanh": ("",),
                "lstm": ("_i", "_f", "_c", "_o"),
                "gru": ("_r", "_z", "_o")}[self._mode]

    def _zeros_like_states(self, merged_input, axis):
        """(L*D, N, H) zeros with N taken from the input symbol."""
        d = 2 if self._bidirectional else 1
        batch_axis = 1 - axis  # the N axis of the (N,T,C)/(T,N,C) input
        z = sym.mean(merged_input * 0.0, axis=-1, keepdims=False)  # (N,T)/(T,N)
        z = sym.mean(z, axis=1 - batch_axis if batch_axis == 0 else 0,
                     keepdims=True)                                # (N,1)/(1,N)
        if batch_axis == 1:
            z = sym.swapaxes(z, 0, 1)                              # (N,1)
        z = sym.tile(z, reps=(1, self._num_hidden))                # (N,H)
        z = sym.expand_dims(z, axis=0)                             # (1,N,H)
        reps = (self._num_layers * d, 1, 1)
        out = [sym.tile(z, reps=reps)]
        if self._mode == "lstm":
            out.append(sym.tile(z, reps=reps))
        return out

    def _weight_slices(self, input_size):
        """Yield (name, start, stop, shape) over the flat vector in the
        fused op's layout (ops/rnn.py:17-20: all [Wx, Wh] blocks layer-
        major direction-minor, then all [bx, bh] blocks), with the
        per-gate names unfuse()'s cells use."""
        g = len(self._gate_names)
        h = self._num_hidden
        dirs = ("l", "r") if self._bidirectional else ("l",)
        d = len(dirs)
        off = 0
        for layer in range(self._num_layers):
            in_sz = input_size if layer == 0 else h * d
            for dname in dirs:
                cell = f"{self._prefix}{dname}{layer}_"
                for j, gate in enumerate(self._gate_names):
                    yield (f"{cell}i2h{gate}_weight",
                           off + j * h * in_sz, off + (j + 1) * h * in_sz,
                           (h, in_sz))
                off += g * h * in_sz
                for j, gate in enumerate(self._gate_names):
                    yield (f"{cell}h2h{gate}_weight",
                           off + j * h * h, off + (j + 1) * h * h, (h, h))
                off += g * h * h
        for layer in range(self._num_layers):
            for dname in dirs:
                cell = f"{self._prefix}{dname}{layer}_"
                for group in ("i2h", "h2h"):
                    for gate in self._gate_names:
                        yield (f"{cell}{group}{gate}_bias",
                               off, off + h, (h,))
                        off += h

    def _param_size(self, input_size):
        from ..ops.rnn import rnn_param_size
        return rnn_param_size(input_size, self._num_hidden,
                              self._num_layers, self._mode,
                              self._bidirectional)

    def _infer_input_size(self, flat_size):
        """Invert ``_param_size`` for the layer-0 input width given the
        flat packed vector's length."""
        g = len(self._gate_names)
        h = self._num_hidden
        d = 2 if self._bidirectional else 1
        per_rest = (self._num_layers - 1) * d * (g * h * (h * d + h)
                                                 + 2 * g * h)
        layer0 = flat_size - per_rest
        input_size = (layer0 - d * (g * h * h + 2 * g * h)) // (d * g * h)
        assert self._param_size(input_size) == flat_size, \
            f"parameter vector size {flat_size} does not match any " \
            f"input width for this cell"
        return input_size

    def unpack_weights(self, args):
        """Split the flat '<prefix>parameters' vector into the per-gate
        arrays unfuse()'s cells bind (reference: rnn_cell.py:638)."""
        from .. import ndarray as nd
        args = dict(args)
        key = f"{self._prefix}parameters"
        if key not in args:
            return args
        flat = args.pop(key)
        flat = flat.asnumpy() if hasattr(flat, "asnumpy") else flat
        input_size = self._infer_input_size(flat.size)
        for name, start, stop, shape in self._weight_slices(input_size):
            args[name] = nd.array(flat[start:stop].reshape(shape))
        return args

    def pack_weights(self, args):
        """Inverse of unpack_weights (reference: rnn_cell.py:650)."""
        import numpy as _np
        from .. import ndarray as nd
        args = dict(args)
        w0 = args[f"{self._prefix}l0_i2h{self._gate_names[0]}_weight"]
        input_size = w0.shape[1]
        flat = _np.zeros(self._param_size(input_size), _np.float32)
        for name, start, stop, shape in self._weight_slices(input_size):
            part = args.pop(name)
            part = part.asnumpy() if hasattr(part, "asnumpy") else part
            flat[start:stop] = part.reshape(-1)
        args[f"{self._prefix}parameters"] = nd.array(flat)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "FusedRNNCell cannot be stepped; use unroll() "
            "(reference has the same restriction)")

    def unroll(self, length, inputs=None, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        if isinstance(inputs, (list, tuple)):
            inputs = sym.stack(*inputs, axis=axis)
        elif inputs is None:
            inputs = sym.var(f"{self._prefix}data")
        if begin_state is None:
            states = self._zeros_like_states(inputs, axis)
        else:
            states = list(begin_state)
        tnc = sym.swapaxes(inputs, 0, 1) if axis == 1 else inputs
        rnn = sym.RNN(tnc, self._parameters, states[0],
                      *(states[1:] if self._mode == "lstm" else ()),
                      state_size=self._num_hidden,
                      num_layers=self._num_layers, mode=self._mode,
                      bidirectional=self._bidirectional, p=self._dropout,
                      state_outputs=self._get_next_state,
                      name=f"{self._prefix}rnn")
        out = rnn[0]
        # reference contract (rnn_cell.py:700-707): states is [] unless
        # get_next_state was requested, in which case it is the FINAL
        # hidden (and cell) state — never the begin states
        if not self._get_next_state:
            next_states = []
        elif self._mode == "lstm":
            next_states = [rnn[1], rnn[2]]
        else:
            next_states = [rnn[1]]
        if axis == 1:
            out = sym.swapaxes(out, 0, 1)
        if merge_outputs is False:
            out = list(sym.split(out, num_outputs=length, axis=axis,
                                 squeeze_axis=1))
        return out, next_states

    def unfuse(self):
        """Equivalent stack of unfused cells (reference:
        rnn_cell.py:735): same gate math, stepping-capable."""
        stack = SequentialRNNCell()
        make = {"rnn_relu": lambda p: RNNCell(self._num_hidden, "relu", p),
                "rnn_tanh": lambda p: RNNCell(self._num_hidden, "tanh", p),
                # forget_bias=0: the packed vector already holds the
                # trained biases, so a fresh init of the unfused cells
                # must not re-apply the forget-gate offset
                "lstm": lambda p: LSTMCell(self._num_hidden,
                                           forget_bias=0.0, prefix=p),
                "gru": lambda p: GRUCell(self._num_hidden, prefix=p)
                }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    make(f"{self._prefix}l{i}_"),
                    make(f"{self._prefix}r{i}_")))
            else:
                stack.add(make(f"{self._prefix}l{i}_"))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix=f"{self._prefix}_dropout{i}_"))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack cells vertically (reference: rnn_cell.py:747)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        return self

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, **kwargs):
        assert not self._modified
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def unpack_weights(self, args):
        for c in self._cells:
            args = c.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for c in self._cells:
            args = c.pack_weights(args)
        return args

    def _split_states(self, states):
        out, i = [], 0
        for c in self._cells:
            n = len(c.state_info)
            out.append(states[i:i + n])
            i += n
        return out

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        for cell, s in zip(self._cells, self._split_states(states)):
            inputs, ns = cell(inputs, s)
            next_states.extend(ns)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Dropout on the step output (reference: rnn_cell.py:826)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self._dropout > 0:
            inputs = sym.Dropout(inputs, p=self._dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """Wrap a cell, reusing its parameters (reference:
    rnn_cell.py:866)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(**kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class ResidualCell(ModifierCell):
    """output = cell(x) + x (reference: rnn_cell.py:956)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(BaseRNNCell):
    """Run two cells over opposite directions; concat outputs
    (reference: rnn_cell.py:997). Step-calling is impossible (the
    backward direction needs the whole sequence) — unroll only."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._cells = [l_cell, r_cell]
        self._output_prefix = output_prefix

    @property
    def state_info(self):
        return [i for c in self._cells for i in c.state_info]

    def begin_state(self, **kwargs):
        assert not self._modified
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def unpack_weights(self, args):
        for c in self._cells:
            args = c.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for c in self._cells:
            args = c.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell cannot be stepped; use unroll()")

    def unroll(self, length, inputs=None, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        came_merged = isinstance(inputs, sym.Symbol)
        if inputs is None:
            inputs = [sym.var(f"bi_t{i}_data") for i in range(length)]
        elif came_merged:
            inputs = list(sym.split(inputs, num_outputs=length, axis=axis,
                                    squeeze_axis=1))
        l_cell, r_cell = self._cells
        nl = len(l_cell.state_info)
        begin_l = begin_state[:nl] if begin_state is not None else None
        begin_r = begin_state[nl:] if begin_state is not None else None
        l_out, l_states = l_cell.unroll(
            length, inputs, begin_l, layout, merge_outputs=False)
        r_out, r_states = r_cell.unroll(
            length, list(reversed(inputs)), begin_r, layout,
            merge_outputs=False)
        outputs = [sym.concat(lo, ro, dim=-1,
                              name=f"{self._output_prefix}t{t}")
                   for t, (lo, ro) in enumerate(
                       zip(l_out, reversed(r_out)))]
        if merge_outputs is None:
            merge_outputs = came_merged
        if merge_outputs:
            outputs = sym.stack(*outputs, axis=axis)
        return outputs, l_states + r_states

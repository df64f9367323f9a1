"""The fused RNN op (the port of ``mxnet_tpu/ops/rnn.py``): LSTM, GRU and
the two vanilla RNNs, over the reference's flat parameter vector.

The JAX op's structure, in PyTorch: one input projection for every step
of a layer and direction (a ``(T*N, I) x (I, G*H)`` product), then a
loop over the steps that carries only ``h @ Wh^T``. The products are
``torch.matmul`` with TF32 off (plain products, which the JAX package
leaves to XLA); torch's autograd gives the backward. ``torch.nn.LSTM``
is not used: its layout and gate arithmetic are cuDNN's, not the JAX
op's.

Gate order: LSTM [i, f, g, o]; GRU [r, z, n] with
``n = tanh(xn + r * (h Wh_n + bh_n))``. The flat vector holds every
[Wx, Wh] block, layer-major and direction-minor, then every [bx, bh]
block (the reference's GetRnnParamSize layout), so one vector carries
across the two packages as it is. Dropout (``p`` while training) acts
between layers only, as cuDNN's, drawn from the op's generator; JAX's
bernoulli bits are not reproduced.
"""
from __future__ import annotations

import torch

from .elemwise import relu
from .linalg import _f32_products
from .registry import _REGISTRY, Operator, alias

__all__ = ["rnn_param_size", "rnn_cell_step", "rnn_layer_scan",
           "rnn_forward"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(input_size, state_size, num_layers, mode,
                   bidirectional=False, projection_size=None):
    """The flat parameter count (the reference's GetRnnParamSize)."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        size += d * (g * state_size * (in_sz + state_size)
                     + 2 * g * state_size)
    return size


def _unpack_params(params, input_size, state_size, num_layers, mode,
                   bidirectional):
    """The flat vector as one dict (wx, wh, bx, bh) per layer and
    direction: views, no copy."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    h = state_size
    weights = []
    off = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else h * d
        lw = []
        for _ in range(d):
            wx = params[off:off + g * h * in_sz].reshape(g * h, in_sz)
            off += g * h * in_sz
            wh = params[off:off + g * h * h].reshape(g * h, h)
            off += g * h * h
            lw.append({"wx": wx, "wh": wh})
        weights.append(lw)
    for layer in range(num_layers):
        for di in range(d):
            weights[layer][di]["bx"] = params[off:off + g * h]
            off += g * h
            weights[layer][di]["bh"] = params[off:off + g * h]
            off += g * h
    return weights


def rnn_cell_step(mode, xproj, h, c, wh, bh):
    """One step of lstm, rnn_relu or rnn_tanh (GRU's reset-gated
    candidate is in :func:`_gru_layer_scan`): ``xproj`` is the step's
    input projection (N, G*H). Returns (out, new_h, new_c)."""
    gates = xproj + torch.matmul(h, wh.t()) + bh
    if mode == "lstm":
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        new_c = f * c + i * g
        new_h = o * torch.tanh(new_c)
        return new_h, new_h, new_c
    new_h = torch.tanh(gates) if mode == "rnn_tanh" else relu(gates)
    return new_h, new_h, c


def _project(x, w):
    t, n, _ = x.shape
    return (torch.matmul(x.reshape(t * n, -1), w["wx"].t()) + w["bx"]
            ).reshape(t, n, -1)


def rnn_layer_scan(mode, x, h0, c0, w, reverse=False):
    """One direction of one layer (not GRU) over the steps: x (T, N, I),
    h0/c0 (N, H), w the layer's dict. Returns (out (T, N, H), hT, cT)."""
    xproj = _project(x, w)
    steps = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    h, c = h0, c0
    outs = [None] * x.shape[0]
    for s in steps:
        outs[s], h, c = rnn_cell_step(mode, xproj[s], h, c, w["wh"],
                                      w["bh"])
    return torch.stack(outs), h, c


def _gru_layer_scan(x, h0, w, reverse=False):
    xproj = _project(x, w)
    steps = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    h = h0
    outs = [None] * x.shape[0]
    for s in steps:
        xr, xz, xn = torch.chunk(xproj[s], 3, dim=-1)
        hr, hz, hn = torch.chunk(torch.matmul(h, w["wh"].t()) + w["bh"], 3,
                                 dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1 - z) * n + z * h
        outs[s] = h
    return torch.stack(outs), h


def rnn_forward(data, params_flat, h0, c0, mode, state_size, num_layers,
                bidirectional=False, p=0.0, training=False, rng=None):
    """The fused RNN's forward: data (T, N, I), h0 (L*D, N, H). Returns
    (out (T, N, D*H), hT (L*D, N, H), cT (LSTM) or None)."""
    d = 2 if bidirectional else 1
    w = _unpack_params(params_flat, data.shape[-1], state_size, num_layers,
                       mode, bidirectional)
    x = data
    hts, cts = [], []
    with _f32_products((data, params_flat)):
        for layer in range(num_layers):
            outs = []
            for di in range(d):
                h_init = h0[layer * d + di]
                c_init = (c0[layer * d + di] if c0 is not None
                          else torch.zeros_like(h_init))
                if mode == "gru":
                    out, ht = _gru_layer_scan(x, h_init, w[layer][di],
                                              reverse=(di == 1))
                    ct = c_init
                else:
                    out, ht, ct = rnn_layer_scan(mode, x, h_init, c_init,
                                                 w[layer][di],
                                                 reverse=(di == 1))
                outs.append(out)
                hts.append(ht)
                cts.append(ct)
            x = outs[0] if d == 1 else torch.cat(outs, dim=-1)
            if p > 0.0 and training and layer < num_layers - 1 \
                    and rng is not None:
                keep = torch.rand(x.shape, generator=rng, device=x.device,
                                  dtype=torch.float32) < 1.0 - p
                x = torch.where(keep, x / (1.0 - p), torch.zeros(
                    (), dtype=x.dtype, device=x.device))
    ht = torch.stack(hts)
    ct = torch.stack(cts) if mode == "lstm" else None
    return x, ht, ct


def _rnn_op(data, parameters, state, state_cell=None, *, state_size,
            num_layers, mode="lstm", bidirectional=False, p=0.0,
            state_outputs=True, projection_size=None, rng=None,
            _training=False):
    """The fused RNN op: data TNC, states (L*D, N, H); returns (out, hT,
    cT), cT zeros but for LSTM."""
    if projection_size is not None:
        raise NotImplementedError("projection_size is not supported")
    out, ht, ct = rnn_forward(
        data, parameters, state, state_cell, mode, state_size, num_layers,
        bidirectional=bidirectional, p=p, training=_training, rng=rng)
    if ct is None:
        ct = torch.zeros_like(ht)
    return out, ht, ct


_REGISTRY["RNN"] = Operator("RNN", _rnn_op, nout=3, needs_rng=True,
                            needs_train=True)
alias("rnn", "RNN")

"""Checkpoint helpers for mx.rnn cells (a copy of
``mxnet_tpu/rnn/rnn.py``).

Reference: python/mxnet/rnn/rnn.py (save_rnn_checkpoint:32,
load_rnn_checkpoint:62, do_rnn_checkpoint:97). Fused cells store one
flat parameter vector; checkpoints are saved in the UNPACKED per-gate
form so they interchange with unfused stacks (and survive a later
change of fusion strategy), then re-packed on load.
"""
from __future__ import annotations

import warnings

from ..model import save_checkpoint, load_checkpoint
from .rnn_cell import BaseRNNCell

__all__ = ["rnn_unroll", "save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint"]


def rnn_unroll(cell, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC"):
    """Deprecated alias of ``cell.unroll`` (reference: rnn.py:26 — same
    positional order, so legacy calls keep their meaning). The
    ``input_prefix`` argument only ever named auto-created input
    variables; our unroll names them from the cell prefix, so it is
    accepted and ignored."""
    warnings.warn("rnn_unroll is deprecated; call cell.unroll directly.",
                  DeprecationWarning)
    del input_prefix
    return cell.unroll(length, inputs=inputs, begin_state=begin_state,
                       layout=layout)


def _as_cells(cells):
    return [cells] if isinstance(cells, BaseRNNCell) else list(cells)


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params,
                        aux_params):
    """save_checkpoint with fused weights unpacked first
    (reference: rnn.py:32)."""
    for cell in _as_cells(cells):
        arg_params = cell.unpack_weights(arg_params)
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """load_checkpoint + re-pack the per-gate arrays into each cell's
    fused form (reference: rnn.py:62)."""
    sym, arg, aux = load_checkpoint(prefix, epoch)
    for cell in _as_cells(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback version (reference: rnn.py:97); drop-in for
    ``mx.callback.do_checkpoint`` in Module.fit."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback

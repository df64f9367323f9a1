"""Updater of the port (mirrors ``mxnet_tpu/optimizer/updater.py``): wraps
an Optimizer and keeps the states of each index; picklable, so a
trainer's optimizer states can be saved and loaded.

States pickle as numpy arrays (a bfloat16 state as ``("bfloat16",
float32 array)``, since numpy has no bfloat16), so a states file does
not depend on a device: loaded states go to their weight's device at
their next update.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

__all__ = ["Updater", "get_updater"]


def _to_host(state):
    """A state tree with each tensor as a numpy array."""
    if isinstance(state, torch.Tensor):
        t = state.detach().cpu()
        if t.dtype == torch.bfloat16:
            return ("bfloat16", t.float().numpy())
        return t.numpy()
    if isinstance(state, (tuple, list)):
        return type(state)(_to_host(s) for s in state)
    return state


def _to_device(state, device):
    """A state tree with each numpy array (or tensor) as a tensor on
    ``device``."""
    if isinstance(state, torch.Tensor):
        return state.to(device)
    if isinstance(state, np.ndarray):
        return torch.from_numpy(state.copy()).to(device)
    if isinstance(state, tuple) and len(state) == 2 \
            and isinstance(state[0], str) and state[0] == "bfloat16":
        return torch.from_numpy(state[1].copy()).to(device, torch.bfloat16)
    if isinstance(state, (tuple, list)):
        return type(state)(_to_device(s, device) for s in state)
    return state


class Updater:
    """Per-index optimizer state holder (reference: updater.py:28)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if not isinstance(index, (list, tuple)):
            indices, grads, weights = [index], [grad], [weight]
        else:
            indices, grads, weights = list(index), list(grad), list(weight)
        for i, idx in enumerate(indices):
            if idx not in self.states:
                self.states[idx] = \
                    self.optimizer.create_state_multi_precision(idx,
                                                                weights[i])
                self.states_synced[idx] = True
            elif not self.states_synced[idx]:
                self.states[idx] = self.sync_state_context(
                    self.states[idx], weights[i].device)
                self.states_synced[idx] = True
            self.optimizer.update_multi_precision(idx, weights[i], grads[i],
                                                  self.states[idx])

    def sync_state_context(self, state, device):
        """``state`` with its arrays as tensors on ``device``."""
        return _to_device(state, device)

    def set_states(self, states):
        """Load states pickled by :meth:`get_states`."""
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            self.states, self.optimizer = states
        else:
            self.states = states
        self.states_synced = dict.fromkeys(self.states.keys(), False)

    def get_states(self, dump_optimizer=False):
        host = {k: _to_host(v) for k, v in self.states.items()}
        return pickle.dumps((host, self.optimizer) if dump_optimizer
                            else host)


def get_updater(optimizer):
    return Updater(optimizer)

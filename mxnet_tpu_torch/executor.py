"""Executor: a bound symbolic graph (the port of ``mxnet_tpu/executor.py``;
reference: python/mxnet/executor.py + src/executor/graph_executor.cc).

The JAX package jits the forward and rematerialises it in a jitted vjp.
The port runs the graph eagerly on the bound tensors, each op's impl in
turn (so an op with a hand-written kernel launches it on the card):

- ``forward(is_train=True)`` records autograd from fresh leaves over the
  argument tensors that take a gradient, and writes the BatchNorm running
  statistics into the aux arrays in place;
- ``backward(out_grads=None)`` takes ``torch.autograd.grad`` of the
  outputs (ones as the head gradient, as the reference's) and keeps the
  graph, so a second ``backward()`` after one forward gives the same
  gradients; a dropout mask is the forward's, saved by autograd;
- ``grad_req`` ``write`` copies the gradient into its array, ``add``
  adds it, ``null`` takes none.

The arrays keep the tensors of the bind (inputs are copied in, so their
addresses stay those of the bind); an input of another shape (a last
batch of another size) replaces its array's tensor, as the JAX
package's executor takes any shape.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["Executor"]


class Executor:
    """Holds the bound arrays of a Symbol and runs its forward and
    backward."""

    def __init__(self, symbol, ctx, args: Dict[str, NDArray],
                 args_grad: Optional[Dict[str, NDArray]], grad_req,
                 aux_states: Dict[str, NDArray]):
        self._symbol = symbol
        self._ctx = ctx
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.input_names = symbol.list_inputs()
        self.arg_dict = dict(args)
        self.aux_dict = dict(aux_states)
        if isinstance(grad_req, str):
            grad_req = {n: grad_req for n in self.arg_names}
        self.grad_req = grad_req
        self.grad_dict = dict(args_grad) if args_grad else {}
        self.outputs: List[NDArray] = []
        self._fns = {}
        # (outputs, leaves) of the last training forward
        self._last = None
        self._monitor_callback = None

    # ------------------------------------------------------- array views --
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self.arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self.arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self.aux_names]

    def _fn(self, is_train):
        fn = self._fns.get(is_train)
        if fn is None:
            fn = self._fns[is_train] = self._symbol._build_fn(
                self.input_names, collect_aux=True, is_train=is_train)
        return fn

    def forward(self, is_train=False, **kwargs):
        """Run the forward (reference: executor.py forward). ``kwargs``
        are copied into the bound arrays of those names."""
        for k, v in kwargs.items():
            if k not in self.arg_dict and k not in self.aux_dict:
                raise MXNetError(f"unknown input {k!r}")
            tgt = self.arg_dict.get(k, self.aux_dict.get(k))
            src = v._data if isinstance(v, NDArray) else torch.as_tensor(v)
            if tuple(src.shape) == tuple(tgt._data.shape):
                with torch.no_grad():
                    tgt._data.copy_(src)
            else:
                # another batch size: the array takes the input's shape,
                # as the reference's does
                tgt._data = src.detach().to(device=tgt._data.device,
                                            dtype=tgt._data.dtype,
                                            copy=True)
        arrays = []
        for n in self.input_names:
            a = self.arg_dict.get(n, self.aux_dict.get(n))
            if a is None:
                raise MXNetError(f"input {n!r} was not bound")
            arrays.append(a._data)
        is_train = bool(is_train)
        if is_train:
            self._last = None   # free the last step's graph first
            wrt = {n for n in self.arg_names
                   if self.grad_req.get(n, "null") != "null"}
            leaves = {}
            for i, n in enumerate(self.input_names):
                if n in wrt and arrays[i].is_floating_point():
                    arrays[i] = leaves[n] = \
                        arrays[i].detach().requires_grad_(True)
            with torch.enable_grad():
                outs, aux = self._fn(True)(*arrays)
        else:
            with torch.no_grad():
                outs, aux = self._fn(False)(*arrays)
        outs = outs if isinstance(outs, tuple) else (outs,)
        self.outputs = [NDArray(o.detach()) for o in outs]
        if is_train:
            self._last = (outs, leaves)
            with torch.no_grad():
                for n, v in aux.items():
                    if n in self.aux_dict:
                        self.aux_dict[n]._data.copy_(v)
        if self._monitor_callback is not None:
            for name, o in zip(self._symbol.list_outputs(), self.outputs):
                self._monitor_callback(name, o)
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """Write the gradients of the last training forward into the
        grad arrays by ``grad_req``; the head gradient is ``out_grads``,
        else ones."""
        if self._last is None:
            raise MXNetError("call forward(is_train=True) before backward")
        outs, leaves = self._last
        if out_grads is None:
            cots = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, (NDArray, torch.Tensor)):
                out_grads = [out_grads]
            cots = [g._data if isinstance(g, NDArray) else
                    torch.as_tensor(g, device=o.device)
                    for g, o in zip(out_grads, outs)]
        names = list(leaves)
        taped = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
        if names and taped:
            grads = torch.autograd.grad(
                [o for o, _ in taped], [leaves[n] for n in names],
                grad_outputs=[c for _, c in taped], retain_graph=True,
                allow_unused=True)
        else:
            grads = [None] * len(names)
        with torch.no_grad():
            for n, g in zip(names, grads):
                req = self.grad_req.get(n, "null")
                if g is None:
                    g = torch.zeros_like(leaves[n])
                buf = self.grad_dict.get(n)
                if buf is None:
                    self.grad_dict[n] = NDArray(g.detach().clone())
                elif req == "add":
                    buf._data.add_(g)
                else:
                    buf._data.copy_(g)

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor bound at the shapes ``kwargs`` give (zero
        arrays there, the other arrays shared; reference:
        executor.py:reshape)."""
        args = {}
        for n in self.arg_names:
            old = self.arg_dict[n]
            if n in kwargs:
                args[n] = NDArray(torch.zeros(
                    tuple(kwargs[n]), dtype=old._data.dtype,
                    device=old._data.device))
            else:
                args[n] = old
        grads = {n: NDArray(torch.zeros_like(a._data))
                 for n, a in args.items()
                 if self.grad_req.get(n, "null") != "null"} \
            if self.grad_dict else None
        return Executor(self._symbol, self._ctx, args, grads,
                        self.grad_req, dict(self.aux_dict))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Load parameter values (reference: executor.py
        copy_params_from)."""
        for name, array in arg_params.items():
            if name in self.arg_dict:
                array.copyto(self.arg_dict[name])
            elif not allow_extra_params:
                raise ValueError(f"Found name \"{name}\" that is not in "
                                 "the arguments")
        if aux_params:
            for name, array in aux_params.items():
                if name in self.aux_dict:
                    array.copyto(self.aux_dict[name])
                elif not allow_extra_params:
                    raise ValueError(f"Found name \"{name}\" that is not "
                                     "in the auxiliary states")

    def set_monitor_callback(self, callback, monitor_all=False):
        self._monitor_callback = callback

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

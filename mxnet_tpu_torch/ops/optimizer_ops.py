"""Optimizer update ops of the port (mirrors
``mxnet_tpu/ops/optimizer_ops.py``), on one hand-written multi-tensor
kernel (``csrc/multi_tensor_update.cu``).

Each op is registered as a ``mutates`` op: :func:`~.invoke.apply_op`
writes its results into the inputs it names (the weight and the
optimizer's states), in place. Each has a plain PyTorch twin here, in
the JAX op's order of operations, one rounding per operation. A CPU
tensor takes the twin; a CUDA tensor takes the kernel over a list of one
parameter, or the call raises.

:func:`multi_update` applies one op to many parameters at once: on the
card in one launch of the kernel over a launch table (per tensor its
pointers, its element count and its row of the scalar table), on the CPU
through the twin, tensor by tensor. ``optimizer.fused.FusedUpdater``
calls it once per (op, dtype) group of a step.

The kernel keeps the twin's bits. Every scalar is computed on the host
in float64 and rounded to float32 once, as torch rounds a Python scalar
(``1 - beta1`` is rounded from the double); the kernel does each
operation of the twin in its order with ``__fmul_rn``-style intrinsics,
which nvcc never contracts. Torch's CUDA division by a Python scalar
multiplies by its reciprocal, so the twin divides by a 0-d tensor of the
scalar instead (:func:`_div`), which both devices divide exactly.

The ``lamb_update_phase*`` ops are not here: LAMB's two phases need a
norm between them on the host, so LAMB is not fusable and waits with
the other optimizers (ROADMAP.md §1 item 13).
"""
from __future__ import annotations

import ctypes
import inspect

import numpy as np
import torch

from .. import kernels
from .registry import _REGISTRY, Operator

__all__ = ["RULES", "multi_update", "UpdateTable", "scalar_rows",
           "SCALAR_ROW", "CHUNK", "RESCALE_WORD", "bytes_per_element"]

# floats per row of the scalar table, and elements a CTA takes at a time
# (both as in csrc/multi_tensor_update.cu)
SCALAR_ROW = 16
CHUNK = 32768
# the int64 word of a row (floats 10-11, past _adamw_update's ten
# scalars) that holds the device address of _adamw_update's rescale
# array; 0: the row's float rescale_grad
RESCALE_WORD = 5
_LOW = (torch.bfloat16, torch.float16)
_WDTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _prep(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


def _div(x, s):
    """``x / s`` for a Python scalar ``s``, divided exactly on either
    device (the kernel's ``__fdiv_rn``)."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def _clip(x, bound):
    if bound is not None and bound > 0:
        x = x.clamp(-bound, bound)
    return x


def _clip_or_off(c):
    """A clip bound as the kernel reads it: negative means none."""
    return -1.0 if c is None else float(c)


# ------------------------------------------------------------- twins --
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True):
    g = _prep(grad, rescale_grad, clip_gradient)
    return weight - lr * (g + wd * weight)


def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight)
    return weight + new_mom, new_mom


def _nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    g = _prep(grad.to(torch.float32), rescale_grad, clip_gradient)
    w32 = weight32 - lr * (g + wd * weight32)
    return w32.to(weight.dtype), w32


def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=True):
    g = _prep(grad.to(torch.float32), rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight32)
    w32 = weight32 + new_mom
    return w32.to(weight.dtype), new_mom, w32


def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=True):
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * (g * g)
    return weight - lr * m / (torch.sqrt(v) + epsilon), m, v


def _adamw_update(weight, grad, mean, var, rescale_grad_arr=None, lr=0.001,
                  beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                  rescale_grad=1.0, clip_gradient=-1.0):
    rs = rescale_grad_arr if rescale_grad_arr is not None else rescale_grad
    g = grad * rs
    if clip_gradient is not None and clip_gradient >= 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * (g * g)
    return (weight - eta * (lr * m / (torch.sqrt(v) + epsilon) + wd * weight),
            m, v)


def _rmsprop_update(weight, grad, n, lr=0.001, rho=0.9, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = rho * n + (1 - rho) * (g * g)
    w = weight - lr * g / torch.sqrt(new_n + epsilon)
    return _clip(w, clip_weights), new_n


def _rmspropalex_update(weight, grad, n, g_avg, delta, lr=0.001, rho=0.9,
                        momentum=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = rho * n + (1 - rho) * (g * g)
    new_g = rho * g_avg + (1 - rho) * g
    new_delta = (momentum * delta
                 - lr * g / torch.sqrt(new_n - new_g * new_g + epsilon))
    return _clip(weight + new_delta, clip_weights), new_n, new_g, new_delta


def _ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_n = n + g * g
    sigma = _div(torch.sqrt(new_n) - torch.sqrt(n), lr)
    new_z = z + g - sigma * weight
    w = torch.where(
        new_z.abs() <= lamda1, torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * lamda1)
        / (_div(beta + torch.sqrt(new_n), lr) + wd))
    return w, new_z, new_n


def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


def _signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1 - momentum) * (g + wd * weight)
    w = (1 - lr * wd_lh) * weight + lr * torch.sign(new_mom)
    return w, new_mom


def _adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    new_h = history + g * g
    return weight - lr * g / (torch.sqrt(new_h) + epsilon), new_h


# --------------------------------------------- the kernel's scalar rows --
# each rule's row of the scalar table, in csrc/multi_tensor_update.cu's
# layout, from the op's keyword arguments with the twin's defaults (f64)
def _row_sgd(k):
    return (k["lr"], k["wd"], k["rescale_grad"],
            _clip_or_off(k["clip_gradient"]))


def _row_mom(k):
    return (k["lr"], k["momentum"], k["wd"], k["rescale_grad"],
            _clip_or_off(k["clip_gradient"]))


def _row_adam(k):
    return (k["lr"], k["beta1"], 1 - k["beta1"], k["beta2"], 1 - k["beta2"],
            k["epsilon"], k["wd"], k["rescale_grad"],
            _clip_or_off(k["clip_gradient"]))


def _row_adamw(k):
    return (k["lr"], k["beta1"], 1 - k["beta1"], k["beta2"], 1 - k["beta2"],
            k["epsilon"], k["wd"], k["eta"], k["rescale_grad"],
            _clip_or_off(k["clip_gradient"]))


def _row_rmsprop(k):
    return (k["lr"], k["rho"], 1 - k["rho"], k["epsilon"], k["wd"],
            k["rescale_grad"], _clip_or_off(k["clip_gradient"]),
            _clip_or_off(k["clip_weights"]))


def _row_rmspropalex(k):
    return (k["lr"], k["rho"], 1 - k["rho"], k["momentum"], k["epsilon"],
            k["wd"], k["rescale_grad"], _clip_or_off(k["clip_gradient"]),
            _clip_or_off(k["clip_weights"]))


def _row_ftrl(k):
    return (k["lr"], k["lamda1"], k["beta"], k["wd"], k["rescale_grad"],
            _clip_or_off(k["clip_gradient"]))


def _row_signum(k):
    return (k["lr"], k["momentum"], 1 - k["momentum"], k["wd"],
            1 - k["lr"] * k["wd_lh"], k["rescale_grad"],
            _clip_or_off(k["clip_gradient"]))


def _row_adagrad(k):
    return (k["lr"], k["epsilon"], k["wd"], k["rescale_grad"],
            _clip_or_off(k["clip_gradient"]))


class _Rule:
    """One update op: its twin, its rule number in the kernel, the
    number of tensor inputs it takes and the indices it writes, and its
    row of scalars."""

    __slots__ = ("name", "rule_id", "twin", "n_in", "mutates", "row", "mp",
                 "defaults")

    def __init__(self, name, rule_id, twin, n_in, row, mp=False):
        self.name, self.rule_id, self.twin = name, rule_id, twin
        self.n_in, self.row, self.mp = n_in, row, mp
        # every input but the gradient (index 1) is written
        self.mutates = (0,) + tuple(range(2, n_in))
        self.defaults = {
            p.name: p.default for p in
            inspect.signature(twin).parameters.values()
            if p.default is not inspect.Parameter.empty}

    def scalars(self, kw):
        return self.row({**self.defaults, **kw})


# op name -> rule, in the kernel's rule numbering
RULES = {r.name: r for r in (
    _Rule("sgd_update", 0, _sgd_update, 2, _row_sgd),
    _Rule("sgd_mom_update", 1, _sgd_mom_update, 3, _row_mom),
    _Rule("nag_mom_update", 2, _nag_mom_update, 3, _row_mom),
    _Rule("mp_sgd_update", 3, _mp_sgd_update, 3, _row_sgd, mp=True),
    _Rule("mp_sgd_mom_update", 4, _mp_sgd_mom_update, 4, _row_mom,
          mp=True),
    _Rule("adam_update", 5, _adam_update, 4, _row_adam),
    _Rule("_adamw_update", 6, _adamw_update, 4, _row_adamw),
    _Rule("rmsprop_update", 7, _rmsprop_update, 3, _row_rmsprop),
    _Rule("rmspropalex_update", 8, _rmspropalex_update, 5,
          _row_rmspropalex),
    _Rule("ftrl_update", 9, _ftrl_update, 4, _row_ftrl),
    _Rule("signsgd_update", 10, _signsgd_update, 2, _row_sgd),
    _Rule("signum_update", 11, _signum_update, 3, _row_signum),
    _Rule("_adagrad_update", 12, _adagrad_update, 3, _row_adagrad),
)}


def bytes_per_element(name, wdtype=torch.float32):
    """Bytes the op moves for one element of a parameter: each input
    read once (an mp op does not read its 16-bit weight) and each written
    input written once."""
    rule = RULES[name]
    wsize = torch.empty((), dtype=wdtype).element_size()
    reads = (0 if rule.mp else wsize) + wsize + 4 * (rule.n_in - 2)
    return reads + wsize + 4 * (rule.n_in - 2)


def scalar_rows(name, kwargs_list, grads):
    """The per-step table of op ``name`` for these calls: one 64-byte row
    per call, ``SCALAR_ROW - 2`` float32 scalars (each computed in
    float64, rounded once) and, in the last eight bytes, the address of
    the call's gradient (``grads``), which moves from step to step as
    autograd hands out a new gradient tensor. A ``_adamw_update`` call
    given ``rescale_grad_arr`` (a one-element f32 tensor on the card)
    has its address in int64 word :data:`RESCALE_WORD`: the kernel reads
    the scale from it on the device, in place of ``rescale_grad``, so no
    host sync reads it and a captured step takes whatever it holds."""
    rule = RULES[name]
    rows = np.zeros((len(kwargs_list), SCALAR_ROW), np.float64)
    for k, kw in enumerate(kwargs_list):
        vals = rule.scalars(kw)
        rows[k, :len(vals)] = vals
    rows = rows.astype(np.float32)
    words = rows.view(np.int64)
    words[:, SCALAR_ROW // 2 - 1] = [g.data_ptr() for g in grads]
    for k, kw in enumerate(kwargs_list):
        arr = kw.get("rescale_grad_arr")
        if arr is not None:
            words[k, RESCALE_WORD] = arr.data_ptr()
    return rows


# ------------------------------------------------------------ the kernel --
def _want_dtype(rule, xs, j):
    return xs[0].dtype if rule.mp and j < 2 else torch.float32


def _check_inputs(rule, xs):
    """Raise unless ``xs`` is what the kernel takes for ``rule``: the op's
    tensor inputs on one CUDA device, contiguous, of one size, f32 (an
    mp op: 16-bit weight and gradient of one dtype, f32 states)."""
    if len(xs) != rule.n_in:
        raise ValueError(f"{rule.name} takes {rule.n_in} tensors, got "
                         f"{len(xs)}")
    dev, n = xs[0].device, xs[0].numel()
    for j, x in enumerate(xs):
        if x.device != dev:
            raise ValueError(f"{rule.name}: input {j} is on {x.device}, "
                             f"the weight on {dev}")
        if x.numel() != n:
            raise ValueError(f"{rule.name}: input {j} has {x.numel()} "
                             f"elements, the weight {n}")
        if not x.is_contiguous():
            raise ValueError(f"{rule.name}: input {j} must be contiguous")
        if x.dtype != _want_dtype(rule, xs, j):
            raise TypeError(f"{rule.name}: input {j} has dtype {x.dtype}, "
                            f"the kernel takes {_want_dtype(rule, xs, j)}")
    if rule.mp and xs[0].dtype not in _LOW:
        raise TypeError(f"{rule.name} takes a bfloat16 or float16 weight, "
                        f"got {xs[0].dtype}")


def _upload(array, device):
    """One host-to-device copy of a numpy array, from pinned memory."""
    host = torch.from_numpy(np.ascontiguousarray(array)).pin_memory()
    return host.to(device, non_blocking=True)


class UpdateTable:
    """The launch table of one op over a list of parameters: per tensor
    its weight's and up to three states' pointers (the gradient's comes
    with each step's rows, :meth:`rows`), its element count, its first
    chunk and its row, as eight int64 words; uploaded once. It holds
    while the weights and states stay where they are."""

    def __init__(self, name, tensor_lists):
        rule = RULES[name]
        self.name, self.rule = name, rule
        words = np.zeros((len(tensor_lists), 8), np.int64)
        chunk, kept = 0, 0
        for k, xs in enumerate(tensor_lists):
            _check_inputs(rule, xs)
            n = xs[0].numel()
            if n == 0:
                continue
            words[kept, 0] = xs[0].data_ptr()
            for j, x in enumerate(xs[2:]):
                words[kept, 2 + j] = x.data_ptr()
            words[kept, 5:] = (n, chunk, k)
            chunk += -(-n // CHUNK)
            kept += 1
        self.device = tensor_lists[0][0].device
        self.wdtype = _WDTYPE[tensor_lists[0][0].dtype]
        for xs in tensor_lists:
            if _WDTYPE[xs[0].dtype] != self.wdtype:
                raise TypeError(f"{name}: one launch takes one weight dtype")
            if xs[0].device != self.device:
                raise ValueError(f"{name}: one launch takes one device, got "
                                 f"{xs[0].device} and {self.device}")
        # what each step's gradients must be
        self.grad_meta = [(x[0].numel(), _want_dtype(rule, x, 1))
                          for x in tensor_lists]
        self.ntensors, self.nchunks = kept, chunk
        self.words = _upload(words[:kept], self.device) if kept else None

    def rows(self, kwargs_list, grads):
        """This step's rows (:func:`scalar_rows`), after checking that
        each gradient is what the kernel takes, and each rescale array
        (``_adamw_update``'s ``rescale_grad_arr``) one f32 element on the
        table's device."""
        for g, (n, dtype) in zip(grads, self.grad_meta, strict=True):
            if g.device != self.device or g.dtype != dtype or \
                    g.numel() != n or not g.is_contiguous():
                raise ValueError(
                    f"{self.name}: a gradient ({g.dtype}, {g.numel()} "
                    f"elements on {g.device}) is not the contiguous "
                    f"{dtype} of {n} elements on {self.device} the kernel "
                    "takes")
        for kw in kwargs_list:
            arr = kw.get("rescale_grad_arr")
            if arr is None:
                continue
            if self.name != "_adamw_update":
                raise TypeError(f"{self.name} takes no rescale_grad_arr")
            if arr.device != self.device or arr.dtype != torch.float32 \
                    or arr.numel() != 1:
                raise ValueError(
                    f"_adamw_update: rescale_grad_arr ({arr.dtype}, "
                    f"{arr.numel()} elements on {arr.device}) is not the "
                    f"one float32 element on {self.device} the kernel "
                    "takes")
        return scalar_rows(self.name, kwargs_list, grads)

    def launch(self, rows):
        """One launch over the table with this step's ``rows`` (a CUDA
        tensor of :meth:`rows`, or an address into one)."""
        if not self.ntensors:
            return
        lib = kernels.library("multi_tensor_update")
        ptr = rows if isinstance(rows, int) else rows.data_ptr()
        rc = lib.mxt_multi_tensor_update(
            self.rule.rule_id, self.wdtype, self.words.data_ptr(),
            self.ntensors, self.nchunks, ctypes.c_void_p(ptr),
            kernels.stream_handle(self.device))
        kernels.check(rc, f"multi_tensor_update ({self.name})")
        kernels.count_launch(self.name)


def _write_back(rule, xs, outs):
    outs = (outs,) if isinstance(outs, torch.Tensor) else outs
    with torch.no_grad():
        for m, o in zip(rule.mutates, outs):
            xs[m].copy_(o)


def multi_update(name, tensor_lists, kwargs_list, table=None):
    """Apply update op ``name`` to every parameter of ``tensor_lists``
    (each the op's tensor inputs, in its order) with the keyword
    arguments of ``kwargs_list``, in place. On the card: one launch of
    the kernel (over ``table``, an :class:`UpdateTable` of these
    tensors, if given), its rows uploaded in one copy; on the CPU: the
    twin, parameter by parameter. Returns the table used."""
    rule = RULES[name]
    if tensor_lists[0][0].device.type == "cpu":
        for xs, kw in zip(tensor_lists, kwargs_list):
            _write_back(rule, xs, rule.twin(*xs, **kw))
        return None
    if table is None:
        table = UpdateTable(name, tensor_lists)
    rows = table.rows(kwargs_list, [xs[1] for xs in tensor_lists])
    table.launch(_upload(rows, table.device))
    return table


def _op(rule):
    """The registered impl: the twin on the CPU, the kernel over one
    parameter on the card (which updates in place and returns the
    inputs it wrote)."""
    def impl(*xs, **kw):
        if xs[0].device.type == "cpu":
            return rule.twin(*xs, **kw)
        if len(xs) > rule.n_in:
            # _adamw_update's fifth input, rescale_grad_arr, rides the
            # row (scalar_rows) as the address the kernel reads it from
            kw = dict(kw, rescale_grad_arr=xs[rule.n_in])
            xs = xs[:rule.n_in]
        multi_update(rule.name, [xs], [kw])
        out = tuple(xs[m] for m in rule.mutates)
        return out[0] if len(out) == 1 else out
    impl.__name__ = rule.name
    impl.__doc__ = rule.twin.__doc__
    # nd.<op>(w, g, 0.1) binds positionals by the twin's parameters
    impl.__signature__ = inspect.signature(rule.twin)
    return impl


for _rule in RULES.values():
    _REGISTRY[_rule.name] = Operator(
        _rule.name, _op(_rule), nout=len(_rule.mutates),
        differentiable=False, mutates=_rule.mutates)

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
scalar instead (:func:`_div`), which both devices divide exactly. On
bf16 or f16 weights (a net cast to 16 bits, no ``multi_precision``) a
``low16`` op keeps its states in the weight's dtype and the kernel
rounds each operation's result to it, as torch rounds each op of the
twin on such tensors.

:func:`multi_apply` is the functional form the multi-tensor ops of
:mod:`.extra` run on: the results in fresh tensors (or in given ones,
in place where those are the inputs), one launch. Beside the 13 rules of
``mxnet_tpu/ops/optimizer_ops.py`` the kernel has three of
``mxnet_tpu/ops/extra.py``: ``mp_nag_mom_update``, ``_mp_adamw_update``
and ``ftml_update`` (there a clip bound of 0 or less means none:
:func:`clip_bound`).

``lamb_update_phase1`` / ``lamb_update_phase2`` are plain PyTorch on
either device (the JAX ops are plain ``jnp``): LAMB's two phases take
the weight's and the step's norms between them, so LAMB is not fusable
and has no kernel rule. Phase 1 returns the step and the new moments
without writing its inputs (the reference registers it with no
``mutates``); its ``t`` is an int and stays a static kwarg.
"""
from __future__ import annotations

import ctypes
import inspect

import numpy as np
import torch

from .. import kernels
from .elemwise import sign
from .registry import _REGISTRY, Operator

__all__ = ["RULES", "multi_update", "multi_apply", "UpdateTable",
           "lamb_phase1", "lamb_phase2",
           "scalar_rows", "SCALAR_ROW", "CHUNK", "RESCALE_WORD", "LR_WORD",
           "WD_WORD", "bytes_per_element"]

# floats per row of the scalar table, and elements a CTA takes at a time
# (both as in csrc/multi_tensor_update.cu)
SCALAR_ROW = 16
CHUNK = 32768
# the int64 word of a row (floats 10-11, past _adamw_update's ten
# scalars) that holds the device address of _adamw_update's rescale
# array; 0: the row's float rescale_grad
RESCALE_WORD = 5
# the int64 words of an SGD rule's row (sgd, sgd_mom and their mp forms;
# floats 6-9, past their five scalars) that hold the device addresses of
# its lr and wd, read in place of the row's floats: the preloaded_multi_*
# ops take lrs and wds as arrays on the card; 0: the row's floats
LR_WORD, WD_WORD = 3, 4
_RESCALE_ARR_OPS = ("_adamw_update", "_mp_adamw_update")
_LR_WD_OPS = ("sgd_update", "sgd_mom_update", "mp_sgd_update",
              "mp_sgd_mom_update")
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
        -(new_z - sign(new_z) * lamda1)
        / (_div(beta + torch.sqrt(new_n), lr) + wd))
    return w, new_z, new_n


def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    return weight - lr * (sign(g) + wd * weight)


def _signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1 - momentum) * (g + wd * weight)
    w = (1 - lr * wd_lh) * weight + lr * sign(new_mom)
    return w, new_mom


def _adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    new_h = history + g * g
    return weight - lr * g / (torch.sqrt(new_h) + epsilon), new_h


# the update ops of mxnet_tpu/ops/extra.py; there a clip bound of 0 or
# less means none (:func:`clip_bound` maps it to -1 for the kernel)
def _mp_nag_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad.to(torch.float32), rescale_grad,
              clip_bound(clip_gradient)) + wd * weight32
    new_mom = momentum * mom - lr * g
    w32 = weight32 + momentum * new_mom - lr * g
    return w32.to(weight.dtype), new_mom, w32


def _mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad=1.0,
                     lr=0.01, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                     eta=1.0, clip_gradient=-1.0, rescale_grad_arr=None):
    rs = rescale_grad_arr if rescale_grad_arr is not None else rescale_grad
    g = _prep(grad.to(torch.float32), rs, clip_bound(clip_gradient))
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * (g * g)
    w32 = weight32 - eta * (lr * m / (torch.sqrt(v) + epsilon)
                            + wd * weight32)
    return w32.to(weight.dtype), m, v, w32


def _ftml_update(weight, grad, d, v, z, lr=0.01, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                 clip_grad=-1.0):
    g = _prep(grad, rescale_grad, clip_bound(clip_grad)) + wd * weight
    new_v = beta2 * v + (1 - beta2) * (g * g)
    d_t = (1 - beta1 ** t) / lr * (torch.sqrt(_div(new_v, 1 - beta2 ** t))
                                   + epsilon)
    new_z = beta1 * z + (1 - beta1) * g - (d_t - beta1 * d) * weight
    return -new_z / d_t, d_t, new_v, new_z


def clip_bound(c):
    """A clip bound of the ``mxnet_tpu/ops/extra.py`` ops (none unless
    positive) as the kernel's rows read one (none when negative)."""
    return -1.0 if c is None or c <= 0 else float(c)


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


def _row_mp_nag(k):
    return (k["lr"], k["momentum"], k["wd"], k["rescale_grad"],
            clip_bound(k["clip_gradient"]))


def _row_mp_adamw(k):
    return (k["lr"], k["beta1"], 1 - k["beta1"], k["beta2"], 1 - k["beta2"],
            k["epsilon"], k["wd"], k["eta"], k["rescale_grad"],
            clip_bound(k["clip_gradient"]))


def _row_ftml(k):
    t = k["t"]
    return (k["beta1"], 1 - k["beta1"], k["beta2"], 1 - k["beta2"],
            k["epsilon"], k["wd"], k["rescale_grad"],
            clip_bound(k["clip_grad"]), (1 - k["beta1"] ** t) / k["lr"],
            1 - k["beta2"] ** t)


class _Rule:
    """One update op: its twin, its rule number in the kernel, the
    number of tensor inputs it takes and the indices it writes, and its
    row of scalars. ``low16``: the kernel also takes it with bf16 or f16
    weights, gradients and states (each operation rounded to their
    dtype, as the twin's torch ops on such tensors round): a Trainer on a
    net cast to 16 bits without ``multi_precision``."""

    __slots__ = ("name", "rule_id", "twin", "n_in", "mutates", "row", "mp",
                 "low16", "defaults")

    def __init__(self, name, rule_id, twin, n_in, row, mp=False,
                 low16=False):
        self.name, self.rule_id, self.twin = name, rule_id, twin
        self.n_in, self.row, self.mp, self.low16 = n_in, row, mp, low16
        # every input but the gradient (index 1) is written
        self.mutates = (0,) + tuple(range(2, n_in))
        self.defaults = {
            p.name: p.default for p in
            inspect.signature(twin).parameters.values()
            if p.default is not inspect.Parameter.empty}

    def scalars(self, kw):
        return self.row({**self.defaults, **kw})


# op name -> rule, in the kernel's rule numbering. Not low16:
# _adamw_update (its rescale array, an f32 tensor, promotes the twin's
# arithmetic to f32), ftrl_update and ftml_update (they divide by a 0-d
# tensor of the weight's dtype, which rounds the divisor first)
RULES = {r.name: r for r in (
    _Rule("sgd_update", 0, _sgd_update, 2, _row_sgd, low16=True),
    _Rule("sgd_mom_update", 1, _sgd_mom_update, 3, _row_mom, low16=True),
    _Rule("nag_mom_update", 2, _nag_mom_update, 3, _row_mom, low16=True),
    _Rule("mp_sgd_update", 3, _mp_sgd_update, 3, _row_sgd, mp=True),
    _Rule("mp_sgd_mom_update", 4, _mp_sgd_mom_update, 4, _row_mom,
          mp=True),
    _Rule("adam_update", 5, _adam_update, 4, _row_adam, low16=True),
    _Rule("_adamw_update", 6, _adamw_update, 4, _row_adamw),
    _Rule("rmsprop_update", 7, _rmsprop_update, 3, _row_rmsprop,
          low16=True),
    _Rule("rmspropalex_update", 8, _rmspropalex_update, 5,
          _row_rmspropalex, low16=True),
    _Rule("ftrl_update", 9, _ftrl_update, 4, _row_ftrl),
    _Rule("signsgd_update", 10, _signsgd_update, 2, _row_sgd, low16=True),
    _Rule("signum_update", 11, _signum_update, 3, _row_signum, low16=True),
    _Rule("_adagrad_update", 12, _adagrad_update, 3, _row_adagrad,
          low16=True),
    _Rule("mp_nag_mom_update", 13, _mp_nag_mom_update, 4, _row_mp_nag,
          mp=True),
    _Rule("_mp_adamw_update", 14, _mp_adamw_update, 5, _row_mp_adamw,
          mp=True),
    _Rule("ftml_update", 15, _ftml_update, 5, _row_ftml),
)}


def bytes_per_element(name, wdtype=torch.float32):
    """Bytes the op moves for one element of a parameter: each input
    read once (an mp op does not read its 16-bit weight) and each written
    input written once (an mp op's states are f32, others' of the
    weight's dtype)."""
    rule = RULES[name]
    wsize = torch.empty((), dtype=wdtype).element_size()
    ssize = 4 if rule.mp else wsize
    reads = (0 if rule.mp else wsize) + wsize + ssize * (rule.n_in - 2)
    return reads + wsize + ssize * (rule.n_in - 2)


def scalar_rows(name, kwargs_list, grads):
    """The per-step table of op ``name`` for these calls: one 64-byte row
    per call, ``SCALAR_ROW - 2`` float32 scalars (each computed in
    float64, rounded once) and, in the last eight bytes, the address of
    the call's gradient (``grads``), which moves from step to step as
    autograd hands out a new gradient tensor. A ``_adamw_update`` or
    ``_mp_adamw_update`` call given ``rescale_grad_arr`` (a one-element
    f32 tensor on the card) has its address in int64 word
    :data:`RESCALE_WORD`: the kernel reads the scale from it on the
    device, in place of ``rescale_grad``, so no host sync reads it and a
    captured step takes whatever it holds. An SGD rule's call given
    ``lr_arr`` or ``wd_arr`` (one f32 element each) has their addresses
    in words :data:`LR_WORD` and :data:`WD_WORD` alike."""
    rule = RULES[name]
    rows = np.zeros((len(kwargs_list), SCALAR_ROW), np.float64)
    for k, kw in enumerate(kwargs_list):
        vals = rule.scalars(kw)
        rows[k, :len(vals)] = vals
    rows = rows.astype(np.float32)
    words = rows.view(np.int64)
    words[:, SCALAR_ROW // 2 - 1] = [g.data_ptr() for g in grads]
    for k, kw in enumerate(kwargs_list):
        for key, word in (("rescale_grad_arr", RESCALE_WORD),
                          ("lr_arr", LR_WORD), ("wd_arr", WD_WORD)):
            arr = kw.get(key)
            if arr is not None:
                words[k, word] = arr.data_ptr()
    return rows


# ------------------------------------------------------------ the kernel --
def _want_dtype(rule, xs, j):
    if rule.mp:
        return xs[0].dtype if j < 2 else torch.float32
    return xs[0].dtype if rule.low16 and xs[0].dtype in _LOW \
        else torch.float32


def _check_inputs(rule, xs):
    """Raise unless ``xs`` is what the kernel takes for ``rule``: the op's
    tensor inputs on one CUDA device, contiguous, of one size, f32 (an
    mp op: 16-bit weight and gradient of one dtype, f32 states; a
    ``low16`` op: all f32, or all bf16, or all f16)."""
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
        # a non-mp rule on 16-bit weights counts apart: sgd_mom_update.bf16
        self.counter = name if rule.mp or not self.wdtype else \
            f"{name}.{('bf16', 'f16')[self.wdtype - 1]}"
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
            for key, ops in (("rescale_grad_arr", _RESCALE_ARR_OPS),
                             ("lr_arr", _LR_WD_OPS), ("wd_arr", _LR_WD_OPS)):
                arr = kw.get(key)
                if arr is None:
                    continue
                if self.name not in ops:
                    raise TypeError(f"{self.name} takes no {key}")
                if arr.device != self.device or \
                        arr.dtype != torch.float32 or arr.numel() != 1:
                    raise ValueError(
                        f"{self.name}: {key} ({arr.dtype}, {arr.numel()} "
                        f"elements on {arr.device}) is not the one float32 "
                        f"element on {self.device} the kernel takes")
        return scalar_rows(self.name, kwargs_list, grads)

    def launch(self, rows, counter=None):
        """One launch over the table with this step's ``rows`` (a CUDA
        tensor of :meth:`rows`, or an address into one), counted under
        ``counter`` (default: the op's name, with ``.bf16`` or ``.f16``
        for a non-mp rule on 16-bit weights)."""
        if not self.ntensors:
            return
        lib = kernels.library("multi_tensor_update")
        ptr = rows if isinstance(rows, int) else rows.data_ptr()
        rc = lib.mxt_multi_tensor_update(
            self.rule.rule_id, self.wdtype, self.words.data_ptr(),
            self.ntensors, self.nchunks, ctypes.c_void_p(ptr),
            kernels.stream_handle(self.device))
        kernels.check(rc, f"multi_tensor_update ({self.name})")
        kernels.count_launch(counter or self.counter)


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


def multi_apply(name, tensor_lists, kwargs_list, counter=None, out=None):
    """The functional form of :func:`multi_update`: op ``name`` over
    every parameter of ``tensor_lists``, its results in fresh tensors
    (or in ``out``: per parameter the tensors to write, in the op's
    ``mutates`` order) and its inputs left as they were, unless ``out``
    names them. The weight and states are copied to the results (one
    ``_foreach_copy_``; an mp op's 16-bit weight, which the kernel only
    writes, is not; a result that is its own input is not) and the
    update runs on the results in place: on the card one launch of the
    kernel over them, counted under ``counter``. Returns, per parameter,
    the tensors written, in the op's ``mutates`` order."""
    rule = RULES[name]
    dsts, srcs, results = [], [], []
    for k, xs in enumerate(tensor_lists):
        ys = list(xs)
        for j, m in enumerate(rule.mutates):
            ys[m] = torch.empty_like(xs[m]) if out is None else out[k][j]
            if ys[m] is not xs[m] and not (rule.mp and m == 0):
                dsts.append(ys[m])
                srcs.append(xs[m])
        results.append(ys)
    if dsts:
        with torch.no_grad():
            torch._foreach_copy_(dsts, srcs)
    if results and results[0][0].device.type == "cpu":
        for ys, kw in zip(results, kwargs_list):
            _write_back(rule, ys, rule.twin(*ys, **kw))
    elif results:
        table = UpdateTable(name, results)
        rows = table.rows(kwargs_list, [ys[1] for ys in results])
        table.launch(_upload(rows, table.device), counter)
    return [[ys[m] for m in rule.mutates] for ys in results]


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
        if isinstance(kw.get("rescale_grad"), torch.Tensor):
            # _mp_adamw_update's rescale_grad given as an array: the same
            kw = dict(kw, rescale_grad_arr=kw["rescale_grad"],
                      rescale_grad=1.0)
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


# ------------------------------------------------------------- LAMB --
def lamb_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB's step before the trust ratio: (the bias-corrected Adam
    direction plus ``wd * weight``, the new mean, the new var)."""
    g = _prep(grad, rescale_grad, clip_gradient)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * torch.square(g)
    if bias_correction:
        mhat = _div(m, 1 - beta1 ** t)
        vhat = _div(v, 1 - beta2 ** t)
    else:
        mhat, vhat = m, v
    return mhat / (torch.sqrt(vhat) + epsilon) + wd * weight, m, v


def lamb_ratio(r1, r2, lower_bound, upper_bound):
    """The trust ratio ``r1 / r2`` (1 unless both norms are positive),
    held within the bounds that are positive."""
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    if lower_bound is not None and lower_bound > 0:
        ratio = torch.clamp_min(ratio, lower_bound)
    if upper_bound is not None and upper_bound > 0:
        ratio = torch.clamp_max(ratio, upper_bound)
    return ratio


def lamb_phase2(weight, g, r1, r2, lr=0.01, lower_bound=-1.0,
                upper_bound=-1.0):
    """``weight - lr * ratio * g`` with LAMB's trust ratio of the norms
    ``r1`` (the weight's) and ``r2`` (the step's)."""
    return weight - lr * lamb_ratio(r1, r2, lower_bound, upper_bound) * g


_REGISTRY["lamb_update_phase1"] = Operator(
    "lamb_update_phase1", lamb_phase1, nout=3, differentiable=False)
_REGISTRY["lamb_update_phase2"] = Operator(
    "lamb_update_phase2", lamb_phase2, nout=1, differentiable=False,
    mutates=(0,))

"""``amp`` of the port: automatic mixed precision (mirrors
``mxnet_tpu/amp/__init__.py``).

Reference: python/mxnet/contrib/amp/amp.py. As in the JAX package, the
casts happen at the op chokepoint (:data:`..ops.invoke._AMP`, applied by
``apply_op`` and by the gluon-facing functions of :mod:`..ops.nn` and
the attention op under their registered names), by the reference's
lists (:mod:`.lists`): the tensor-core ops run in the target dtype while
the master weights stay float32. No ``torch.autocast``: its op lists are
not the reference's. Under ``amp.init()`` BERT's attention reaches the
bf16 flash kernels (``flash_fwd.bf16``, ``flash_bwd_dkv.bf16``,
``flash_bwd_dq.bf16``; f16 under ``target_dtype="float16"``).

Usage (mirrors the reference):
    amp.init()                       # bf16-first policy
    amp.init_trainer(trainer)
    with amp.scale_loss(loss, trainer) as scaled:
        scaled.backward()
    trainer.step(batch_size)         # unscales, skips on overflow
"""
from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

from ..ops import invoke as _invoke
from .lists import F32_OPS, LP_OPS
from .loss_scaler import LossScaler

__all__ = ["init", "uninit", "init_trainer", "scale_loss",
           "convert_hybrid_block", "convert_model", "LossScaler"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}

_initialized = False
_target_dtype = None


def _torch_dtype(target_dtype):
    if isinstance(target_dtype, torch.dtype):
        return target_dtype
    try:
        return _DTYPES[str(target_dtype)]
    except KeyError:
        raise ValueError(f"AMP target dtype must be one of "
                         f"{sorted(_DTYPES)}, got {target_dtype!r}") from None


def _dtype_name(target_dtype):
    d = _torch_dtype(target_dtype)
    return next(n for n, t in _DTYPES.items() if t == d)


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Activate mixed precision (reference: amp.py:283 ``init``).

    target_dtype: 'bfloat16' (the default) or 'float16'. Extra op lists
    extend the built-in classification.
    """
    global _initialized, _target_dtype
    d = _torch_dtype(target_dtype)
    lp = set(LP_OPS) | set(target_precision_ops or ())
    f32 = set(F32_OPS) | set(fp32_ops or ())
    if conditional_fp32_ops:
        f32 |= {name for name, _cond, _vals in conditional_fp32_ops}
    _invoke._AMP.update(active=True, dtype=d, lp_ops=frozenset(lp),
                        f32_ops=frozenset(f32))
    _initialized = True
    _target_dtype = _dtype_name(target_dtype)


def uninit():
    """Deactivate mixed precision casting."""
    global _initialized
    _invoke._AMP.update(active=False)
    _initialized = False


def init_trainer(trainer, loss_scaler=None):
    """Attach dynamic loss scaling to a Trainer (reference: amp.py
    init_trainer). Wraps ``trainer.step`` to unscale gradients and skip
    the update on overflow."""
    if getattr(trainer, "_amp_original_step", None) is not None:
        return trainer
    scaler = loss_scaler or LossScaler(
        target_dtype=_target_dtype or "bfloat16")
    trainer._amp_loss_scaler = scaler
    trainer._amp_original_step = trainer.step

    def amp_step(batch_size, ignore_stale_grad=False):
        if scaler.loss_scale != 1.0 and scaler.has_overflow(
                trainer._params):
            scaler.update_scale(overflow=True)
            warnings.warn(
                f"AMP: gradient overflow, skipping update and reducing "
                f"loss scale to {scaler.loss_scale}", stacklevel=2)
            return
        prev = trainer._scale
        trainer._scale = prev / scaler.loss_scale
        try:
            trainer._amp_original_step(batch_size, ignore_stale_grad)
        finally:
            trainer._scale = prev
        scaler.update_scale(overflow=False)

    trainer.step = amp_step
    return trainer


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """Yield the loss multiplied by the current loss scale
    (reference: amp.py scale_loss)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None or scaler.loss_scale == 1.0:
        yield loss
        return
    if isinstance(loss, (list, tuple)):
        yield type(loss)(l * scaler.loss_scale for l in loss)
    else:
        yield loss * scaler.loss_scale


def convert_hybrid_block(block, target_dtype="bfloat16"):
    """Cast a HybridBlock for low-precision inference
    (reference: amp.py convert_hybrid_block)."""
    block.cast(_dtype_name(target_dtype))
    return block


def _cast_leaf(v, d):
    """A floating tensor or numpy array in ``d``; anything else as it
    is. numpy has no bfloat16, so a numpy array comes back as a tensor
    in that case."""
    if isinstance(v, torch.Tensor):
        return v.to(d) if v.is_floating_point() else v
    a = np.asarray(v)
    if a.dtype.kind != "f":
        return v
    if d == torch.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(a)).to(d)
    return a.astype(torch.empty((), dtype=d).numpy().dtype)


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16"):
    """Cast a model's parameter dicts, of tensors or numpy arrays
    (reference: amp.py convert_model); ``sym`` is returned as it is:
    dtypes flow from the parameters."""
    d = _torch_dtype(target_dtype)
    cast_args = {k: _cast_leaf(v, d) for k, v in arg_params.items()}
    cast_aux = {k: _cast_leaf(v, d) for k, v in aux_params.items()}
    return sym, cast_args, cast_aux

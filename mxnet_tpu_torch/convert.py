"""Carry the JAX package's weights across into the port.

:func:`params_from_numpy` turns the host numpy tree of
``mxnet_tpu.serving.llm.TinyDecoder.init_params`` (nested dicts and
lists of float32 arrays), or a quantized checkpoint (any object with
``params``, ``scales`` and ``dtype``, such as the JAX package's
``QuantizedWeights``), into the port's tensors on ``device``. fp8 and
bf16 leaves (``ml_dtypes.float8_e4m3fn`` / ``ml_dtypes.bfloat16`` on the
JAX side; also as the raw ``|V1`` / ``|V2`` they become where
``ml_dtypes`` is not loaded, as in a decoder artifact's npz) arrive as
raw bytes and are viewed as
``torch.float8_e4m3fn`` / ``torch.bfloat16``, so no ``ml_dtypes`` is
needed where the port runs.

:func:`load_gluon_params` copies a gluon parameter set, as numpy arrays
by name (the JAX package's ``net.collect_params()``), into a port block,
so both packages compute the same function from the same weights.

:func:`arg_aux_from_numpy` carries the ``(arg_params, aux_params)`` pair
of the symbolic API (``{name: NDArray}`` dicts of the JAX package's
``Module.get_params()``, or numpy arrays) into the port's NDArrays on
``device``, so both packages bind the same weights.
"""
from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["params_from_numpy", "tensor_from_numpy", "numpy_from_tensor",
           "load_gluon_params", "arg_aux_from_numpy"]

# numpy dtype names that torch.from_numpy does not take -> (the numpy
# integer type of their bytes, the torch dtype to view them as); a raw
# 1-byte void (``|V1``) is an fp8 e4m3 element, a raw 2-byte void
# (``|V2``) a bf16 element, that lost its dtype
_RAW = {"float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
        "bfloat16": (np.int16, torch.bfloat16),
        "void8": (np.uint8, torch.float8_e4m3fn),
        "void16": (np.int16, torch.bfloat16)}


def tensor_from_numpy(a, device):
    """One leaf: numpy array (fp8 and bf16 viewed from their bytes) or
    tensor → tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    raw = _RAW.get(a.dtype.name)
    if raw is not None:
        bits, dtype = raw
        return torch.from_numpy(a.view(bits)).view(dtype).to(device)
    return torch.from_numpy(a).to(device)


# torch dtypes numpy has no name for -> the integer type of their bytes
# and the void type they travel as
_VOID = {torch.float8_e4m3fn: (torch.uint8, "V1"),
         torch.bfloat16: (torch.int16, "V2")}


def numpy_from_tensor(leaf):
    """A host numpy array of ``leaf``'s bytes (the inverse of
    :func:`tensor_from_numpy`): fp8 and bfloat16 tensors as ``|V1`` /
    ``|V2`` views; a numpy array passes through."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu().contiguous()
    if t.dtype in _VOID:
        bits, void = _VOID[t.dtype]
        return t.view(bits).numpy().view(void)
    return t.numpy()


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


def params_from_numpy(tree, device):
    """A param tree, or a quantized checkpoint, with every leaf as a
    tensor on ``device``. A checkpoint comes back as the port's
    :class:`~.serving.llm.quant.QuantizedWeights`."""
    device = torch.device(device)
    if all(hasattr(tree, a) for a in ("params", "scales", "dtype")):
        # imported here: the serving package imports this module
        from .serving.llm.quant import QuantizedWeights
        return QuantizedWeights(
            _tree(tree.params, device),
            {k: tensor_from_numpy(v, device)
             for k, v in tree.scales.items()},
            tree.dtype, getattr(tree, "method", "absmax"),
            getattr(tree, "methods", None))
    return _tree(tree, device)


def _root_pattern(prefix):
    """Regex for a root prefix: a counter-made ``<alias><n>_`` matches
    any count (global name counters differ between processes)."""
    m = re.fullmatch(r"(.*?)\d+_", prefix)
    return re.escape(m.group(1)) + r"\d+_" if m else re.escape(prefix)


def load_gluon_params(block, arrays):
    """Copy ``arrays`` (``{name: numpy array}``, e.g. from the JAX
    package's ``net.collect_params()``) into ``block``'s parameters.

    Names are matched after the root prefix: the port's ``block.prefix``
    and, in ``arrays``, the same prefix with any counter (global name
    counters differ between processes, so ``bertformlm3_...`` matches
    ``bertformlm0_...``). A parameter whose shape is still deferred takes the array's shape
    and is materialised on the device its ``initialize`` named. Every
    parameter takes its array, ``grad_req="null"`` ones (BatchNorm's
    running statistics) and ``Constant``s too; arrays keep their layout
    (an NHWC net's OHWI weights as they are) and bf16 arrays arrive
    through :func:`tensor_from_numpy`. Raises on a missing, extra or
    mis-shaped name.
    """
    ours = block.collect_params()
    root = block.prefix
    pat = re.compile(_root_pattern(root))
    theirs = {}
    for key, arr in arrays.items():
        m = pat.match(key)
        if m is None:
            raise KeyError(f"'{key}' is not under the root prefix "
                           f"'{root}'")
        theirs[key[m.end():]] = arr
    mine = {name[len(root):]: p for name, p in ours.items()}
    missing = sorted(set(mine) - set(theirs))
    extra = sorted(set(theirs) - set(mine))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"extra {extra}")
    for rel, param in mine.items():
        arr = np.asarray(theirs[rel])
        try:
            param.shape = arr.shape
        except ValueError as e:
            raise ValueError(f"'{rel}': array shape {arr.shape} does not "
                             f"fit parameter shape {param.shape}") from e
        if tuple(param.shape) != arr.shape:
            raise ValueError(f"'{rel}': array shape {arr.shape}, "
                             f"parameter shape {param.shape}")
        param.set_data(tensor_from_numpy(arr, "cpu"))
        param._finish_deferred_init()


def arg_aux_from_numpy(arg_params, aux_params, device):
    """``(arg_params, aux_params)`` as two dicts of the port's NDArrays on
    ``device``; each value is a numpy array or anything with
    ``asnumpy()`` (the JAX package's NDArray); ``device`` a Context,
    string or ``torch.device``."""
    from ._device import resolve_device
    from .ndarray import NDArray
    dev = resolve_device(device)

    def one(d):
        return {k: NDArray(tensor_from_numpy(
            v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v),
            dev)) for k, v in (d or {}).items()}
    return one(arg_params), one(aux_params)

"""Carry the JAX package's weights across into the port.

:func:`params_from_numpy` turns the host numpy tree of
``mxnet_tpu.serving.llm.TinyDecoder.init_params`` (nested dicts and
lists of float32 arrays), or a quantized checkpoint (any object with
``params``, ``scales`` and ``dtype``, such as the JAX package's
``QuantizedWeights``), into the port's tensors on ``device``. fp8 leaves
(``ml_dtypes.float8_e4m3fn`` on the JAX side) arrive as raw bytes and
are viewed as ``torch.float8_e4m3fn``, so no ``ml_dtypes`` is needed
where the port runs.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(a, device):
    """One leaf: numpy array (fp8 viewed from its bytes) or tensor →
    tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint8))
        return t.view(torch.float8_e4m3fn).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


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

"""The port's ``MXNetError`` and its dtype-code table (the port of the
parts of ``mxnet_tpu/base.py`` that the on-disk formats need).

The codes are the reference's (mshadow type flags), kept so that NDArray
containers (``nd.save``/``nd.load``) are byte-compatible across the two
packages. Code 12 is bfloat16: here ``torch.bfloat16``, which numpy
cannot name without ``ml_dtypes``, so the table maps codes to torch
dtypes and the containers move bfloat16 as raw bytes.
"""
from __future__ import annotations

import torch

__all__ = ["MXNetError", "dtype_code", "dtype_name", "torch_dtype",
           "itemsize"]


class MXNetError(RuntimeError):
    """Framework error type (reference: python/mxnet/base.py MXNetError)."""


_DTYPE_CODE_TO_TORCH = {
    0: torch.float32, 1: torch.float64, 2: torch.float16, 3: torch.uint8,
    4: torch.int32, 5: torch.int8, 6: torch.int64, 7: torch.bool,
    12: torch.bfloat16,
}
_TORCH_TO_DTYPE_CODE = {v: k for k, v in _DTYPE_CODE_TO_TORCH.items()}
# the dtype names numpy (and the reference's metadata) give each code
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.uint8: "uint8",
          torch.int32: "int32", torch.int8: "int8", torch.int64: "int64",
          torch.bool: "bool", torch.bfloat16: "bfloat16"}
_BY_NAME = {v: k for k, v in _NAMES.items()}
_BY_NAME.update({"bool_": torch.bool, "float": torch.float32,
                 "double": torch.float64, "half": torch.float16,
                 "bf16": torch.bfloat16})


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype for any dtype spec: a torch dtype, an int code, a
    name (``"float32"``, ``"bfloat16"``, ...) or a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, int):
        return _DTYPE_CODE_TO_TORCH[dtype]
    name = dtype if isinstance(dtype, str) else \
        getattr(dtype, "name", None) or str(dtype)
    try:
        return _BY_NAME[name]
    except KeyError:
        import numpy as np
        return _BY_NAME[np.dtype(dtype).name]


def dtype_code(dtype) -> int:
    """The reference's type code of ``dtype``."""
    return _TORCH_TO_DTYPE_CODE[torch_dtype(dtype)]


def dtype_name(dtype) -> str:
    """The numpy name of ``dtype`` (``"bfloat16"`` for bfloat16), as the
    reference's checkpoint metadata writes it."""
    return _NAMES[torch_dtype(dtype)]


def itemsize(dtype) -> int:
    """Bytes of one element of ``dtype``."""
    return torch.empty((), dtype=torch_dtype(dtype)).element_size()

"""Operators of the PyTorch/CUDA port (mirrors ``mxnet_tpu/ops``).

Importing this package registers the ops whose modules the port has:
``ragged_paged_attention`` (:mod:`.ragged_attention`) and
``scaled_dot_product_attention`` (:mod:`.flash_attention`) and the
optimizer update ops (:mod:`.optimizer_ops`).
"""
from . import flash_attention, optimizer_ops, ragged_attention  # noqa: F401

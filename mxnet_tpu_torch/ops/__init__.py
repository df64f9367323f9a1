"""Operators of the PyTorch/CUDA port (mirrors ``mxnet_tpu/ops``).

Importing this package registers the ops whose modules the port has:
``ragged_paged_attention`` (:mod:`.ragged_attention`) and
``scaled_dot_product_attention`` (:mod:`.flash_attention`), the
optimizer update ops (:mod:`.optimizer_ops`) and ``lora_delta``
(:mod:`.lora`).
"""
from . import (flash_attention, lora, optimizer_ops,  # noqa: F401
               ragged_attention)

"""Operators of the PyTorch/CUDA port (mirrors ``mxnet_tpu/ops``).

Importing this package registers the ops whose modules the port has:
the elementwise, reduction, shape, linalg, random and nn families
(:mod:`.elemwise`, :mod:`.reduce`, :mod:`.shape_ops`, :mod:`.linalg`,
:mod:`.random_ops`, :mod:`.nn`), ``ragged_paged_attention``
(:mod:`.ragged_attention`) and ``scaled_dot_product_attention``
(:mod:`.flash_attention`), the optimizer update ops
(:mod:`.optimizer_ops`) with the multi-tensor update tail and its
reductions (:mod:`.extra`), and ``lora_delta`` (:mod:`.lora`).
"""
from . import (elemwise, extra, flash_attention, linalg, lora,  # noqa: F401
               nn, optimizer_ops, ragged_attention, random_ops, reduce,
               shape_ops)

"""Operators of the PyTorch/CUDA port (mirrors ``mxnet_tpu/ops``).

Importing this package registers the ops whose modules the port has:
the elementwise, reduction, shape, linalg, random and nn families
(:mod:`.elemwise`, :mod:`.reduce`, :mod:`.shape_ops`, :mod:`.linalg`,
:mod:`.random_ops`, :mod:`.nn`), ``ragged_paged_attention``
(:mod:`.ragged_attention`) and ``scaled_dot_product_attention``
(:mod:`.flash_attention`), the optimizer update ops
(:mod:`.optimizer_ops`), the long tail of :mod:`.extra` (the
multi-tensor update tail and its reductions, the legacy output layers,
the spatial, index, image and ``_npx_``/``_npi_`` ops), the detection
ops (:mod:`.contrib_det`, :mod:`.contrib_det2`), the quantization ops
with ``_contrib_quantized_matmul`` (:mod:`.quantization`), the fused
``RNN`` (:mod:`.rnn`) and ``lora_delta`` (:mod:`.lora`).
"""
from . import (contrib_det, contrib_det2, elemwise, extra,  # noqa: F401
               flash_attention, linalg, lora, nn, optimizer_ops,
               quantization, ragged_attention, random_ops, reduce, rnn,
               shape_ops)

"""Operators of the PyTorch/CUDA port (mirrors ``mxnet_tpu/ops``)."""

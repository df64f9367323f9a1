"""Optimizers of the port (mirrors ``mxnet_tpu/optimizer``): Adam and
AdamW with MXNet's update rules."""
from .optimizer import Optimizer, register, create, Adam, AdamW  # noqa: F401

__all__ = ["Optimizer", "register", "create", "Adam", "AdamW"]

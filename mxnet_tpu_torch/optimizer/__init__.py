"""Optimizers of the port (mirrors ``mxnet_tpu/optimizer``): the nine
optimizers whose update is one update op, the ``Updater`` and the fused
step (:class:`FusedUpdater`)."""
from .optimizer import (Optimizer, register, create, SGD, NAG,  # noqa: F401
                        Adam, AdamW, AdaGrad, RMSProp, Ftrl, Signum,
                        SignSGD)
from .updater import Updater, get_updater  # noqa: F401
from .fused import FusedUpdater, fusable  # noqa: F401

__all__ = ["Optimizer", "register", "create", "Updater", "get_updater",
           "FusedUpdater", "fusable", "SGD", "NAG", "Adam", "AdamW",
           "AdaGrad", "RMSProp", "Ftrl", "Signum", "SignSGD"]

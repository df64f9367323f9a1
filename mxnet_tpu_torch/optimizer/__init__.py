"""Optimizers of the port (mirrors ``mxnet_tpu/optimizer``): the
reference's 20 optimizers, the ``Updater`` and the fused step
(:class:`FusedUpdater`, over the nine whose update is one update op)."""
from .optimizer import (Optimizer, register, create, SGD, NAG,  # noqa: F401
                        Adam, AdamW, AdaGrad, AdaDelta, Adamax, Nadam,
                        RMSProp, FTML, Ftrl, LAMB, LARS, DCASGD, SGLD,
                        Signum, SignSGD, LBSGD, GroupAdaGrad, Test)
from .updater import Updater, get_updater  # noqa: F401
from .fused import FusedUpdater, fusable  # noqa: F401

__all__ = ["Optimizer", "register", "create", "Updater", "get_updater",
           "FusedUpdater", "fusable", "SGD", "NAG", "Adam", "AdamW",
           "AdaGrad", "AdaDelta", "Adamax", "Nadam", "RMSProp", "FTML",
           "Ftrl", "LAMB", "LARS", "DCASGD", "SGLD", "Signum", "SignSGD",
           "LBSGD", "GroupAdaGrad", "Test"]

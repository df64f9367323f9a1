"""Gluon of the port (mirrors ``mxnet_tpu/gluon``): Block/HybridBlock on
``torch.nn.Module``, Parameter/Constant/ParameterDict, the layers
(``nn``, ``rnn``), the losses, ``utils`` and the Trainer; ``data``,
``model_zoo`` and ``contrib`` load at first touch, as the reference's
do."""
from .parameter import (Parameter, Constant, ParameterDict,  # noqa: F401
                        DeferredInitializationError)
from .block import Block, HybridBlock, SymbolBlock, CachedOp  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from . import loss  # noqa: F401
from . import utils  # noqa: F401


def __getattr__(name):
    if name in ("data", "model_zoo", "contrib"):
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'mxnet_tpu_torch.gluon' has no attribute "
                         f"{name!r}")

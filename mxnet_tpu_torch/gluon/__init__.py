"""Gluon of the port (mirrors ``mxnet_tpu/gluon``): Block/HybridBlock on
``torch.nn.Module``, Parameter/Constant/ParameterDict, the basic,
convolution, pooling and activation layers, multi-head attention, the
model zoo (BERT and the vision models), the softmax cross-entropy and L2
losses and the Trainer."""
from .parameter import (Parameter, Constant, ParameterDict,  # noqa: F401
                        DeferredInitializationError)
from .block import Block, HybridBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import model_zoo  # noqa: F401

"""Gluon of the port (mirrors ``mxnet_tpu/gluon``): the subset the BERT
training path needs — Block/HybridBlock on ``torch.nn.Module``,
Parameter/ParameterDict, the basic layers, multi-head attention, BERT,
the softmax cross-entropy loss and the Trainer."""
from .parameter import (Parameter, ParameterDict,  # noqa: F401
                        DeferredInitializationError)
from .block import Block, HybridBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import model_zoo  # noqa: F401

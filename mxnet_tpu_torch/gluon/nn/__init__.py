"""Neural network layers of the port (mirrors ``mxnet_tpu/gluon/nn``)."""
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from .activations import *  # noqa: F401,F403
from .attention import *  # noqa: F401,F403
from ..block import Block, HybridBlock  # noqa: F401

"""Gluon recurrent layers and cells of the port (mirrors
``mxnet_tpu/gluon/rnn``)."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403

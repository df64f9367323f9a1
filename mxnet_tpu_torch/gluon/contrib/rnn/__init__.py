"""gluon.contrib.rnn of the port (mirrors
``mxnet_tpu/gluon/contrib/rnn``): the convolutional cells,
``VariationalDropoutCell`` and ``LSTMPCell``."""
from .conv_rnn_cell import (  # noqa: F401
    Conv1DRNNCell, Conv2DRNNCell, Conv3DRNNCell,
    Conv1DLSTMCell, Conv2DLSTMCell, Conv3DLSTMCell,
    Conv1DGRUCell, Conv2DGRUCell, Conv3DGRUCell)
from .rnn_cell import VariationalDropoutCell, LSTMPCell  # noqa: F401

"""gluon.contrib of the port (mirrors ``mxnet_tpu/gluon/contrib``):
``nn``, ``rnn`` and ``estimator``."""
from . import estimator  # noqa: F401
from . import nn  # noqa: F401
from . import rnn  # noqa: F401

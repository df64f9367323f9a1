"""Vision datasets and transforms of the port (mirrors
``mxnet_tpu/gluon/data/vision``)."""
from .datasets import *  # noqa: F401,F403
from . import transforms  # noqa: F401

"""Model zoo of the port (mirrors ``mxnet_tpu/gluon/model_zoo``): BERT."""
from . import bert  # noqa: F401

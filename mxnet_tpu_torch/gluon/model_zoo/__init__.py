"""Model zoo of the port (mirrors ``mxnet_tpu/gluon/model_zoo``): BERT,
the vision models (``vision``, ``get_model``) and SSD-300."""
from . import bert  # noqa: F401
from . import vision  # noqa: F401
from . import ssd  # noqa: F401
from .vision import get_model  # noqa: F401
from .ssd import ssd_300_vgg16_reduced, MultiBoxLoss, SSD  # noqa: F401

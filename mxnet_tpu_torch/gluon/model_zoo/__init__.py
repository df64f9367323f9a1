"""Model zoo of the port (mirrors ``mxnet_tpu/gluon/model_zoo``): BERT and
the vision models (``vision``, ``get_model``). ``ssd.py`` is not ported
yet (ROADMAP.md §1 item 13d)."""
from . import bert  # noqa: F401
from . import vision  # noqa: F401
from .vision import get_model  # noqa: F401

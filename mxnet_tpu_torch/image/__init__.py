"""Image I/O + augmentation (reference: python/mxnet/image/; mirrors
``mxnet_tpu/image``)."""
from .image import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .native_iter import (  # noqa: F401
    ImageRecordIterNative, native_pipeline_available)

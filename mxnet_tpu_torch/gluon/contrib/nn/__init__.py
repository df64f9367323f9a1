"""gluon.contrib.nn of the port (mirrors
``mxnet_tpu/gluon/contrib/nn``): contributed layers."""
from .basic_layers import (  # noqa: F401
    Concurrent, HybridConcurrent, Identity, SparseEmbedding,
    SyncBatchNorm, PixelShuffle1D, PixelShuffle2D, PixelShuffle3D)

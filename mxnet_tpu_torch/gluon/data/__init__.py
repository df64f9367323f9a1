"""Gluon data API of the port (mirrors ``mxnet_tpu/gluon/data``):
datasets, samplers, the ``DataLoader`` and device prefetch."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from .prefetch import (DevicePrefetchIter, stage_batch,  # noqa: F401
                       default_prefetch_depth)
from . import vision  # noqa: F401

"""Data iterators of the port (mirrors ``mxnet_tpu/io``; reference:
python/mxnet/io/)."""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, ResizeIter,
                 PrefetchingIter, CSVIter, LibSVMIter,
                 MXDataIter)  # noqa: F401

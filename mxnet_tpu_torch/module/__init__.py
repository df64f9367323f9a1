"""Module API of the port (mirrors ``mxnet_tpu/module``; reference:
python/mxnet/module/)."""
from .base_module import BaseModule  # noqa: F401
from .module import Module  # noqa: F401
from .bucketing_module import BucketingModule  # noqa: F401
from .sequential_module import SequentialModule  # noqa: F401
from .python_module import PythonModule, PythonLossModule  # noqa: F401

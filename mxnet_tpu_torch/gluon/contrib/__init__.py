"""gluon.contrib of the port (mirrors ``mxnet_tpu/gluon/contrib``):
``nn`` and ``rnn``. ``estimator`` waits for ``metric.py`` and the step
timer (ROADMAP.md §1 item 13e)."""
from . import nn  # noqa: F401
from . import rnn  # noqa: F401


def __getattr__(name):
    if name == "estimator":
        raise AttributeError(
            "module 'mxnet_tpu_torch.gluon.contrib' has no attribute "
            "'estimator': mxnet_tpu.gluon.contrib.estimator is not ported "
            "yet (ROADMAP.md §1 item 13e)")
    raise AttributeError(f"module 'mxnet_tpu_torch.gluon.contrib' has no "
                         f"attribute {name!r}")

"""Vision model zoo of the port (mirrors
``mxnet_tpu/gluon/model_zoo/vision``): ResNet, AlexNet, VGG, SqueezeNet,
DenseNet, MobileNet and Inception V3; ``get_model(name)`` builds any of
them by its constructor's name."""
# module refs captured before star-imports (which shadow e.g. `alexnet`
# with the constructor function of the same name)
from . import resnet as _resnet
from . import alexnet as _alexnet
from . import vgg as _vgg
from . import squeezenet as _squeezenet
from . import densenet as _densenet
from . import mobilenet as _mobilenet
from . import inception as _inception

from .resnet import *  # noqa: F401,F403,E402
from .alexnet import *  # noqa: F401,F403,E402
from .vgg import *  # noqa: F401,F403,E402
from .squeezenet import *  # noqa: F401,F403,E402
from .densenet import *  # noqa: F401,F403,E402
from .mobilenet import *  # noqa: F401,F403,E402
from .inception import *  # noqa: F401,F403,E402

_models = {}
for _m in (_resnet, _alexnet, _vgg, _squeezenet, _densenet, _mobilenet,
           _inception):
    for _name in _m.__all__:
        _obj = getattr(_m, _name)
        if callable(_obj) and _name[0].islower():
            _models[_name] = _obj


def get_model(name, **kwargs):
    """The model of constructor ``name`` (``resnet50_v1``, ``vgg11_bn``
    ...), built with ``kwargs``."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            f"Model {name} is not supported. Available: "
            f"{sorted(_models.keys())}")
    return _models[name](**kwargs)

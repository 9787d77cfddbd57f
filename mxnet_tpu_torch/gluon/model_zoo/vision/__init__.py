"""Vision model zoo of the port (reference:
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``): alexnet, densenet,
inception v3, mobilenet v1 / v2, resnet v1 / v2, squeezenet and vgg (with
the ``_bn`` variants), by the reference's 35 names."""
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
from .alexnet import __all__ as _alexnet
from .densenet import __all__ as _densenet
from .inception import __all__ as _inception
from .mobilenet import __all__ as _mobilenet
from .resnet import __all__ as _resnet
from .squeezenet import __all__ as _squeezenet
from .vgg import __all__ as _vgg

__all__ = (_alexnet + _densenet + _inception + _mobilenet + _resnet
           + _squeezenet + _vgg + ["get_model"])

_MODELS = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,  # noqa: F405
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,  # noqa: F405
    "resnet152_v1": resnet152_v1,  # noqa: F405
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,  # noqa: F405
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,  # noqa: F405
    "resnet152_v2": resnet152_v2,  # noqa: F405
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16,  # noqa: F405
    "vgg19": vgg19, "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn,  # noqa: F405
    "vgg16_bn": vgg16_bn, "vgg19_bn": vgg19_bn,  # noqa: F405
    "alexnet": alexnet,  # noqa: F405
    "densenet121": densenet121, "densenet161": densenet161,  # noqa: F405
    "densenet169": densenet169, "densenet201": densenet201,  # noqa: F405
    "squeezenet1.0": squeezenet1_0,  # noqa: F405
    "squeezenet1.1": squeezenet1_1,  # noqa: F405
    "inceptionv3": inception_v3,  # noqa: F405
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,  # noqa: F405
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,  # noqa: F405
    "mobilenetv2_1.0": mobilenet_v2_1_0,  # noqa: F405
    "mobilenetv2_0.75": mobilenet_v2_0_75,  # noqa: F405
    "mobilenetv2_0.5": mobilenet_v2_0_5,  # noqa: F405
    "mobilenetv2_0.25": mobilenet_v2_0_25,  # noqa: F405
}


def get_model(name, **kwargs):
    """Return a model by name (reference: vision/__init__.py get_model);
    an unknown name raises ``ValueError``."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError("Model %r is not supported. Available: %s" % (
            name, sorted(_MODELS)))
    return _MODELS[name](**kwargs)

"""Vision model zoo of the port (reference:
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``).  ResNet v1 at depths
18/34/50 is ported; ``get_model`` names the ROADMAP item for the rest."""
from .resnet import *  # noqa: F401,F403
from .resnet import __all__ as _resnet

__all__ = list(_resnet) + ["get_model"]

_MODELS = {"resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,  # noqa: F405
           "resnet50_v1": resnet50_v1}  # noqa: F405


def get_model(name, **kwargs):
    """Return a model by name (reference: vision/__init__.py get_model)."""
    name = name.lower()
    if name not in _MODELS:
        raise NotImplementedError(
            "model %r is not ported yet (ROADMAP.md queue A, item 1); "
            "ported: %s" % (name, sorted(_MODELS)))
    return _MODELS[name](**kwargs)

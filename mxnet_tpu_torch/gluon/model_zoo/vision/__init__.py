"""Model zoo for vision (subset of
``mxnet_tpu/gluon/model_zoo/vision/``; parity:
python/mxnet/gluon/model_zoo/vision/).

``get_model('resnet50_v1', classes=10)`` matches the reference factory for
the ResNet family; the other families are not ported yet.
"""
from .resnet import *  # noqa: F401,F403
from . import resnet

_MODELS = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,  # noqa: F405
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,  # noqa: F405
    "resnet152_v1": resnet152_v1,  # noqa: F405
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,  # noqa: F405
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,  # noqa: F405
    "resnet152_v2": resnet152_v2,  # noqa: F405
}


def get_model(name, **kwargs):
    """Returns a pre-defined model by name (model_zoo/vision/__init__.py)."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError(
            f"Model {name} is not supported. Available options are:\n\t"
            + "\n\t".join(sorted(_MODELS)))
    return _MODELS[name](**kwargs)

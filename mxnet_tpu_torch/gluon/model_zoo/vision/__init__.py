"""Model zoo for vision (port of ``mxnet_tpu/gluon/model_zoo/vision/``;
parity: python/mxnet/gluon/model_zoo/vision/).

``get_model(name, **kwargs)`` takes exactly ``mxnet_tpu``'s name set
(``mxnet_tpu/gluon/model_zoo/vision/__init__.py:16-45``); every model is
returned uninitialized, and ``pretrained=True`` raises, as there.
"""
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403

from . import alexnet, densenet, inception, mobilenet, resnet, squeezenet, vgg

_MODELS = {
    "resnet18_v1": resnet.resnet18_v1, "resnet34_v1": resnet.resnet34_v1,
    "resnet50_v1": resnet.resnet50_v1, "resnet101_v1": resnet.resnet101_v1,
    "resnet152_v1": resnet.resnet152_v1,
    "resnet18_v2": resnet.resnet18_v2, "resnet34_v2": resnet.resnet34_v2,
    "resnet50_v2": resnet.resnet50_v2, "resnet101_v2": resnet.resnet101_v2,
    "resnet152_v2": resnet.resnet152_v2,
    "vgg11": vgg.vgg11, "vgg13": vgg.vgg13, "vgg16": vgg.vgg16,
    "vgg19": vgg.vgg19, "vgg11_bn": vgg.vgg11_bn, "vgg13_bn": vgg.vgg13_bn,
    "vgg16_bn": vgg.vgg16_bn, "vgg19_bn": vgg.vgg19_bn,
    # the function: the star import binds it before the module's name
    "alexnet": alexnet,
    "densenet121": densenet.densenet121, "densenet161": densenet.densenet161,
    "densenet169": densenet.densenet169, "densenet201": densenet.densenet201,
    "squeezenet1.0": squeezenet.squeezenet1_0,
    "squeezenet1.1": squeezenet.squeezenet1_1,
    "inceptionv3": inception.inception_v3,
    "mobilenet1.0": mobilenet.mobilenet1_0,
    "mobilenet0.75": mobilenet.mobilenet0_75,
    "mobilenet0.5": mobilenet.mobilenet0_5,
    "mobilenet0.25": mobilenet.mobilenet0_25,
    "mobilenetv2_1.0": mobilenet.mobilenet_v2_1_0,
    "mobilenetv2_0.75": mobilenet.mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet.mobilenet_v2_0_5,
    "mobilenetv2_0.25": mobilenet.mobilenet_v2_0_25,
}


def get_model(name, **kwargs):
    """Returns a pre-defined model by name (model_zoo/vision/__init__.py)."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError(
            f"Model {name} is not supported. Available options are:\n\t"
            + "\n\t".join(sorted(_MODELS)))
    return _MODELS[name](**kwargs)

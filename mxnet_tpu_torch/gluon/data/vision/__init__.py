"""Vision datasets and transforms (port of
``mxnet_tpu/gluon/data/vision``; parity: python/mxnet/gluon/data/vision/)."""
from .datasets import *  # noqa: F401,F403
from . import transforms
from . import datasets

"""Gluon data API (port of ``mxnet_tpu/gluon/data``; parity:
python/mxnet/gluon/data/)."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from . import vision
from . import dataset
from . import sampler
from . import dataloader

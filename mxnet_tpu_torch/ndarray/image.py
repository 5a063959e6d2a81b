"""``mx.nd.image``: the ``_image_*`` ops under their short names (port of
``mxnet_tpu/ndarray/image.py``; parity: python/mxnet/ndarray/image.py):
``mx.nd.image.to_tensor`` is ``_image_to_tensor``."""
from __future__ import annotations

import sys as _sys

_MODULE = _sys.modules[__name__]
_PREFIX = "_image_"


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    from . import __getattr__ as _nd_getattr

    try:
        fn = _nd_getattr(_PREFIX + name)
    except AttributeError:
        fn = _nd_getattr(name)
    setattr(_MODULE, name, fn)
    return fn


def __dir__():
    from ..ops.registry import list_ops

    return sorted(n[len(_PREFIX):] for n in list_ops()
                  if n.startswith(_PREFIX))

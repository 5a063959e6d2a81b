"""``mx.image`` (port of ``mxnet_tpu/image``; parity: python/mxnet/image/)."""
from .image import *  # noqa: F401,F403
from . import image
from . import detection
from .detection import (CreateDetAugmenter, DetAugmenter,  # noqa: F401
                        DetBorrowAug, DetHorizontalFlipAug,
                        DetRandomCropAug, DetRandomPadAug,
                        DetRandomSelectAug, ImageDetIter)

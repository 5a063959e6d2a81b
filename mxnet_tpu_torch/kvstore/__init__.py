"""``mx.kv``: key-value stores, over one process or, with
``dist_sync``, over the workers of a job (port of ``mxnet_tpu/kvstore``)."""
from .kvstore import KVStore, KVStoreDevice, KVStoreLocal, create  # noqa: F401
from . import dist  # noqa: F401
from .dist import KVStoreDist  # noqa: F401

__all__ = ["KVStore", "KVStoreLocal", "KVStoreDevice", "KVStoreDist",
           "create", "dist"]

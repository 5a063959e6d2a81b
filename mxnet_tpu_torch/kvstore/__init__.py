"""``mx.kv``: key-value stores over one process (port of
``mxnet_tpu/kvstore``)."""
from .kvstore import KVStore, KVStoreDevice, KVStoreLocal, create  # noqa: F401

__all__ = ["KVStore", "KVStoreLocal", "KVStoreDevice", "create"]

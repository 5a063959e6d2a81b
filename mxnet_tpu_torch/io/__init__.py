"""Data iterators of the PyTorch port (subset of ``mxnet_tpu/io``)."""
from .io import DataBatch, DataDesc, DataIter, NDArrayIter  # noqa: F401

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter"]

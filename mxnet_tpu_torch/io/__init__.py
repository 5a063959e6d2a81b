"""Data iterators of the PyTorch port (``mxnet_tpu/io``): the in-memory and
file iterators, the RecordIO image pipeline and the streaming layer."""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, ResizeIter,
                 PrefetchingIter, MXDataIter, ImageRecordIter, MNISTIter,
                 CSVIter)
from .stream import (RecordStream, StreamBatchIter, StreamBatch,
                     DevicePrefetcher)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "MXDataIter", "ImageRecordIter", "MNISTIter",
           "CSVIter", "RecordStream", "StreamBatchIter", "StreamBatch",
           "DevicePrefetcher"]

"""Gluon Datasets (port of ``mxnet_tpu/gluon/data/dataset.py``; parity:
python/mxnet/gluon/data/dataset.py: Dataset :29, ArrayDataset :258,
RecordFileDataset :291).
"""
from __future__ import annotations

import os
import threading

from ... import ndarray as nd

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Abstract dataset: __getitem__ + __len__ (gluon/data/dataset.py:29)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([i for i in self if fn(i)])

    def shard(self, num_shards, index):
        assert 0 <= index < num_shards
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return SimpleDataset([self[i] for i in range(start, end)])

    def take(self, count):
        if count is None or count > len(self):
            count = len(self)
        return SimpleDataset([self[i] for i in range(count)])

    def transform(self, fn, lazy=True):
        """Returns a new dataset with each sample transformed by fn."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """Transform only the first element of each sample."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    """Dataset wrapping a list or array (gluon/data/dataset.py:220)."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """Dataset combining multiple array-like objects
    (gluon/data/dataset.py:258)."""

    def __init__(self, *args):
        assert len(args) > 0, "Needs at least 1 arrays"
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                f"All arrays must have the same length; array[0] has length " \
                f"{self._length} while array[{i}] has {len(data)}."
            if isinstance(data, nd.NDArray) and data.ndim == 1:
                data = nd.expand_dims(data, axis=1)
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO file and its ``.idx`` beside it
    (gluon/data/dataset.py:291); each sample is a record's raw bytes.

    Each thread (and each forked worker) reads through a file handle of
    its own, so a DataLoader's thread pool never interleaves one handle's
    seek and read."""

    def __init__(self, filename):
        from ...recordio import MXIndexedRecordIO
        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = MXIndexedRecordIO(self.idx_file, self.filename, "r")
        self._local = threading.local()

    def __getitem__(self, idx):
        from ...recordio import read_logical_record

        local = self._local
        if getattr(local, "pid", None) != os.getpid():
            local.f, local.pid = open(self.filename, "rb"), os.getpid()
        local.f.seek(self._record.idx[self._record.keys[idx]])
        return read_logical_record(local.f)

    def __len__(self):
        return len(self._record.keys)

"""Data iterators (subset of ``mxnet_tpu/io/io.py:17-172``; parity:
python/mxnet/io/io.py): :class:`DataDesc`, :class:`DataBatch`,
:class:`DataIter` and the in-memory :class:`NDArrayIter`, which Module
training reads and INT8 serving calibrates from.

Batches are NDArrays on ``cpu()``, as MXNet's are; a Module or an
executor copies them onto its device. ``shuffle`` draws each epoch's
order from the port's CPU generator (``mx.random.generator("cpu")``, so
``mx.random.seed`` repeats it); ``mxnet_tpu`` shuffles with numpy's
unseeded global generator (``io.py:134``), so the two orders never agree.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as _np
import torch

from ..base import MXNetError

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]

DataDesc = namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])
DataDesc.__new__.__defaults__ = (_np.float32, "NCHW")


class DataBatch:
    """One mini-batch: ``data`` and ``label`` are lists of arrays."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        shapes = [tuple(d.shape) for d in self.data] if self.data else []
        return f"DataBatch: data shapes {shapes} pad={self.pad}"


class DataIter:
    """Iterator base class (io.py:180)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _numpy(v):
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return _np.asarray(v)


def _init_data(data, allow_empty, default_name):
    if data is None:
        data = []
    if not isinstance(data, (list, dict)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise MXNetError("empty data")
        data = ({default_name: data[0]} if len(data) == 1 else
                {f"_{i}_{default_name}": d for i, d in enumerate(data)})
    return [(k, _numpy(v)) for k, v in data.items()]


class NDArrayIter(DataIter):
    """In-memory iterator over arrays with ``last_batch_handle`` "pad"
    (the last batch filled from the front), "discard" or "roll_over"
    (io.py:491)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        self.idx = _np.arange(self.num_data)
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        if last_batch_handle == "discard":
            self.num_batches = self.num_data // batch_size
        else:
            self.num_batches = -(-self.num_data // batch_size)
        self.reset()

    def _descs(self, arrays):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         v.dtype) for k, v in arrays]

    @property
    def provide_data(self):
        return self._descs(self.data)

    @property
    def provide_label(self):
        return self._descs(self.label)

    def reset(self):
        if self.shuffle:
            from .. import random as _random

            self.idx = torch.randperm(
                self.num_data, generator=_random.generator("cpu")).numpy()
        if self.last_batch_handle == "roll_over" and \
                0 < self.cursor < self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _take(self, arrays):
        from ..context import cpu
        from ..ndarray.ndarray import NDArray

        end = min(self.cursor + self.batch_size, self.num_data)
        ids = self.idx[self.cursor:end]
        if len(ids) < self.batch_size:     # pad from the front
            ids = _np.concatenate([ids,
                                   self.idx[:self.batch_size - len(ids)]])
        return [NDArray(torch.from_numpy(_np.ascontiguousarray(v[ids])),
                        cpu()) for _, v in arrays]

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

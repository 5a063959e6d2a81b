"""Data iterators (port of ``mxnet_tpu/io/io.py``; parity:
python/mxnet/io/io.py): :class:`DataDesc`, :class:`DataBatch`,
:class:`DataIter`, the in-memory :class:`NDArrayIter` (which Module
training reads and INT8 serving calibrates from), :class:`ResizeIter`,
:class:`PrefetchingIter`, :func:`MNISTIter`, :func:`CSVIter` and
:func:`ImageRecordIter` (``io/record_pipeline.py``).

Batches are NDArrays on ``cpu()``, as MXNet's are; a Module or an
executor copies them onto its device. ``shuffle`` draws each epoch's
order from the port's CPU generator (``mx.random.generator("cpu")``, so
``mx.random.seed`` repeats it); ``mxnet_tpu`` shuffles with numpy's
unseeded global generator (``io.py:134``), so the two orders never agree.
"""
from __future__ import annotations

import threading
from collections import namedtuple

import numpy as _np
import torch

from ..base import MXNetError

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "MXDataIter", "MNISTIter", "CSVIter",
           "ImageRecordIter"]

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


class ResizeIter(DataIter):
    """Resize an iterator's epoch length (io.py ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Background-thread prefetch (io.py PrefetchingIter; the Python analogue
    of src/io/iter_prefetcher.h's dmlc::ThreadedIter double buffer)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        iters = iters if isinstance(iters, list) else [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.n_iter = len(iters)
        self.current_batch = [None] * self.n_iter
        self.next_batch = [None] * self.n_iter
        self.started = True
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()

        def prefetch(i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch, args=[i], daemon=True)
            for i in range(self.n_iter)]
        for t in self.prefetch_threads:
            t.start()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def __del__(self):
        self.started = False
        for e in self.data_taken:
            e.set()

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        if self.next_batch[0] is None:
            return False
        self.current_batch = DataBatch(
            sum([b.data for b in self.next_batch], []),
            sum([(b.label or []) for b in self.next_batch], []),
            self.next_batch[0].pad, self.next_batch[0].index)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class MXDataIter(DataIter):
    """Placeholder for native-pipeline-backed iterators."""

    def __init__(self, *a, **kw):
        raise MXNetError("this iterator requires the native data pipeline; "
                         "use ImageRecordIter / NDArrayIter")


def MNISTIter(image="train-images-idx3-ubyte", label="train-labels-idx1-ubyte",
              batch_size=128, shuffle=True, flat=False, data_name="data",
              label_name="softmax_label", **kwargs):
    """Parity: src/io/iter_mnist.cc — reads idx-format MNIST files."""
    import gzip
    import struct

    def _open(path):
        return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")

    with _open(label) as f:
        magic, num = struct.unpack(">II", f.read(8))
        lbl = _np.frombuffer(f.read(), dtype=_np.uint8).astype(_np.float32)
    with _open(image) as f:
        magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
        img = _np.frombuffer(f.read(), dtype=_np.uint8).reshape(num, rows, cols)
    img = img.astype(_np.float32) / 255.0
    data = img.reshape(num, -1) if flat else img.reshape(num, 1, rows, cols)
    return NDArrayIter(data, lbl, batch_size=batch_size, shuffle=shuffle,
                       data_name=data_name, label_name=label_name)


def CSVIter(data_csv, data_shape, label_csv=None, label_shape=(1,),
            batch_size=128, **kwargs):
    """Parity: src/io/iter_csv.cc."""
    data = _np.loadtxt(data_csv, delimiter=",", dtype=_np.float32)
    data = data.reshape((-1,) + tuple(data_shape))
    label = None
    if label_csv is not None:
        label = _np.loadtxt(label_csv, delimiter=",", dtype=_np.float32)
    return NDArrayIter(data, label, batch_size=batch_size, **kwargs)


def ImageRecordIter(*args, **kwargs):
    """RecordIO image pipeline (parity: src/io/iter_image_recordio_2.cc),
    ``io.record_pipeline.ImageRecordIter``."""
    from .record_pipeline import ImageRecordIter as _Impl

    return _Impl(*args, **kwargs)

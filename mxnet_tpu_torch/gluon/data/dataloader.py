"""Gluon DataLoader (port of ``mxnet_tpu/gluon/data/dataloader.py``, the
``num_workers=0`` path; parity: python/mxnet/gluon/data/dataloader.py:533).

The samples are read and batched on the host, in the loop's own thread;
each batch then lands on the context current when the loader was made
(``gpu(0)`` unless told otherwise), one host-to-device copy for each
array of the batch. :func:`stats` counts the
batches and those copies. The fork + shared-memory workers and the thread
pool (``num_workers > 0``) are ROADMAP Queue 1 item 10 and raise.
"""
from __future__ import annotations

import numpy as np

from ...base import MXNetError
from ...context import current_context
from ... import ndarray as nd
from ...image.image import host_array
from .sampler import SequentialSampler, RandomSampler, BatchSampler

__all__ = ["DataLoader", "default_batchify_fn", "stats", "reset_stats"]

_STATS = {"dataloader_batches": 0, "dataloader_h2d_copies": 0,
          "dataloader_h2d_bytes": 0}


def stats():
    """Batches served and their host-to-device copies (count, bytes)."""
    return dict(_STATS)


def reset_stats():
    for k in _STATS:
        _STATS[k] = 0


def default_batchify_fn(data):
    """Stack samples into a batch on the host (reference
    dataloader.py:127): NDArrays by ``nd.stack``, tuples field by field,
    anything else through numpy (float64 -> float32, int64 -> int32, as
    ``mxnet_tpu``'s arrays keep them)."""
    if isinstance(data[0], nd.NDArray):
        return nd.stack(*data)
    if isinstance(data[0], tuple):
        return tuple(default_batchify_fn(list(i)) for i in zip(*data))
    return host_array(np.asarray(data))


def _to_ctx(batch, ctx):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_ctx(b, ctx) for b in batch)
    if isinstance(batch, nd.NDArray) and batch.context != ctx:
        _STATS["dataloader_h2d_copies"] += 1
        _STATS["dataloader_h2d_bytes"] += batch.size * \
            batch._data.element_size()
        return batch.as_in_context(ctx)
    return batch


class DataLoader:
    """Loads data from a Dataset and returns mini-batches on the context
    current at construction."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=False, timeout=120):
        if num_workers > 0:
            raise MXNetError("DataLoader(num_workers > 0): the worker "
                             "processes and the thread pool are ROADMAP "
                             "Queue 1 item 10, not ported")
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is "
                    "specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._ctx = current_context()

    def __len__(self):
        return len(self._batch_sampler)

    def __iter__(self):
        for batch_idx in self._batch_sampler:
            batch = self._batchify_fn([self._dataset[i] for i in batch_idx])
            _STATS["dataloader_batches"] += 1
            yield _to_ctx(batch, self._ctx)

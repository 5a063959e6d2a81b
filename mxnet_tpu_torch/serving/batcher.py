"""BatchServer — thread-safe dynamic batching over a Predictor (subset of
``mxnet_tpu/serving/batcher.py``: deadlines, load shedding, health checks
and ``DecodeBatcher`` come with later slices).

``submit(batch)`` enqueues and returns a ``concurrent.futures.Future``; a
background worker pops requests, coalesces up to ``max_batch_size`` rows
or until ``batch_timeout_ms`` after the oldest request arrived, runs ONE
``predict`` on the fused batch (which pads it to the Predictor's nearest
bucket), and hands each future exactly its own rows. Only requests of the
same per-row shape and dtype coalesce; a mixed queue batches in arrival
order. On a CUDA predictor the worker waits for the device before it
resolves the futures, so a request's recorded latency ends when its
results exist.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError

import torch

from ..base import MXNetError
from . import _STATS, record_latency

__all__ = ["BatchServer", "ServerClosed"]


class ServerClosed(RuntimeError):
    """The server is closed (or closing without drain)."""


class _Request:
    __slots__ = ("feeds", "rows", "sig", "future", "t_submit")

    def __init__(self, feeds, rows, sig):
        self.feeds = feeds
        self.rows = rows
        self.sig = sig
        self.future = Future()
        self.t_submit = time.perf_counter()


def _try_resolve(future, result=None, exc=None):
    """First writer wins; a future close() already failed is left alone."""
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
        return True
    except InvalidStateError:
        return False


class BatchServer:
    """Dynamic batcher over a :class:`Predictor`.

    Parameters
    ----------
    predictor : Predictor
    max_batch_size : int — coalescing cap in ROWS (default: the
        predictor's largest declared bucket). A single request may not
        exceed it.
    batch_timeout_ms : float — how long the oldest queued request may wait
        for the batch to fill (default 2.0).
    """

    def __init__(self, predictor, max_batch_size=None, batch_timeout_ms=2.0):
        self.predictor = predictor
        self.max_batch_size = int(max_batch_size if max_batch_size is not None
                                  else max(predictor.buckets))
        self.batch_timeout_s = float(batch_timeout_ms) / 1e3
        self._queue = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._drain = True
        self._worker = threading.Thread(target=self._serve_loop,
                                        name="mxnet-torch-serving",
                                        daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ intake
    def submit(self, data):
        """Enqueue one request (array/tensor or dict name -> array, WITH the
        batch axis; 1..max_batch_size rows). Returns a Future resolving to
        the list of output tensors for exactly those rows. Inputs are
        copied to the predictor's device here, so the caller may reuse its
        buffers once submit returns."""
        feeds, rows = self.predictor._coerce_feeds(data)
        feeds = {name: a.clone() for name, a in feeds.items()}
        if rows < 1 or rows > self.max_batch_size:
            raise MXNetError(f"request rows must be 1..{self.max_batch_size}"
                             f", got {rows}")
        sig = tuple(sorted((n, tuple(a.shape[1:]), str(a.dtype))
                           for n, a in feeds.items()))
        req = _Request(feeds, rows, sig)
        with self._cond:
            if self._closed:
                raise ServerClosed("BatchServer is closed")
            self._queue.append(req)
            _STATS["serving_requests"] += 1
            _STATS["serving_queue_peak"] = max(_STATS["serving_queue_peak"],
                                               len(self._queue))
            self._cond.notify_all()
        return req.future

    # ------------------------------------------------------------------ worker
    def _take_batch(self):
        """Pop the next run of same-signature requests (total rows <=
        max_batch_size), honouring the time trigger. None when closed and
        drained."""
        with self._cond:
            while True:
                if not self._queue:
                    if self._closed:
                        return None
                    self._cond.wait()
                    continue
                head = self._queue[0]
                rows = 0
                for r in self._queue:
                    if r.sig != head.sig:
                        break
                    rows += r.rows
                now = time.perf_counter()
                t_flush = head.t_submit + self.batch_timeout_s
                if rows >= self.max_batch_size or now >= t_flush or \
                        self._closed:
                    batch, rows = [], 0
                    while self._queue and \
                            self._queue[0].sig == head.sig and \
                            rows + self._queue[0].rows <= self.max_batch_size:
                        req = self._queue.popleft()
                        batch.append(req)
                        rows += req.rows
                    return batch
                self._cond.wait(max(0.0, t_flush - now))

    def _serve_loop(self):
        try:
            while True:
                batch = self._take_batch()
                if batch is None:
                    return
                if not self._drain:
                    for r in batch:
                        _try_resolve(r.future, exc=ServerClosed(
                            "BatchServer closed without drain"))
                    continue
                self._execute(batch)
        finally:
            # a dying worker must not leave admitted futures pending
            with self._cond:
                self._closed = True
                leftovers = list(self._queue)
                self._queue.clear()
            for r in leftovers:
                _try_resolve(r.future, exc=ServerClosed(
                    "BatchServer worker stopped"))

    def _execute(self, batch):
        try:
            fused = {name: (batch[0].feeds[name] if len(batch) == 1 else
                            torch.cat([r.feeds[name] for r in batch], dim=0))
                     for name in batch[0].feeds}
            outs, n = self.predictor.predict_raw(fused)
            device = self.predictor.device
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
        except Exception as e:  # fail this batch, keep the queue serving
            for r in batch:
                _try_resolve(r.future, exc=e)
            return
        _STATS["serving_batches"] += 1
        t_done = time.perf_counter()
        offset = 0
        for r in batch:
            sl = slice(offset, offset + r.rows)
            if _try_resolve(r.future, result=[
                    o[sl] if o.dim() and o.shape[0] == n else o
                    for o in outs]):
                record_latency(t_done - r.t_submit)
            offset += r.rows

    # ------------------------------------------------------------------- close
    def close(self, drain=True, timeout=None):
        """Stop intake; with ``drain`` (default) serve every queued request
        first, otherwise fail them with ServerClosed. Idempotent."""
        with self._cond:
            self._closed = True
            self._drain = self._drain and drain
            self._cond.notify_all()
        self._worker.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=exc[0] is None)

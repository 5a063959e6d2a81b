"""Gluon DataLoader (port of ``mxnet_tpu/gluon/data/dataloader.py``; parity:
python/mxnet/gluon/data/dataloader.py:533).

Samples are read and batched on the host, then each batch lands on the
context current when the loader was made (``gpu(0)`` unless told
otherwise), one host-to-device copy an array. Three ways to batch:

- ``num_workers=0``: in the loop's own thread;
- ``num_workers > 0`` (default): forked worker PROCESSES that batch with
  numpy (:func:`numpy_batchify_fn`) and ship each batch through shared
  memory, the reference's multiprocess pool. A worker runs the dataset's
  host code only: numpy, PIL and CPU tensors, one intra-op thread, never
  CUDA (a CUDA context cannot cross a fork), so a dataset that yields
  CUDA arrays runs on the thread pool instead, with a warning. A worker
  that dies is respawned (``max_worker_respawns``,
  ``MXNET_TPU_TORCH_DATALOADER_RESPAWNS``) and its batch resubmitted;
  each batch waits at most ``timeout`` seconds;
- ``thread_pool=True``: threads feeding an ordered prefetch queue.

``pin_memory=True`` pins in the parent only (a worker's batch is copied
out of shared memory straight into pinned memory) and copies it to the
context without blocking. Each ``next`` is spanned ``step.data_wait``.
:func:`stats` counts the batches, the host-to-device copies and bytes,
and the respawns.
"""
from __future__ import annotations

import errno
import os
import queue
import threading

import numpy as np
import torch

from ...base import torch_dtype
from ...context import cpu, current_context
from ... import ndarray as nd
from ...image.image import host_array
from ...observability import trace as _obs_trace
from .sampler import SequentialSampler, RandomSampler, BatchSampler

__all__ = ["DataLoader", "default_batchify_fn", "numpy_batchify_fn",
           "stats", "reset_stats"]

_STATS = {"dataloader_batches": 0, "dataloader_h2d_copies": 0,
          "dataloader_h2d_bytes": 0, "dataloader_respawns": 0}


def stats():
    """Batches served, their host-to-device copies (count, bytes), and
    worker respawns."""
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


def numpy_batchify_fn(data):
    """Stack samples into numpy batches: the worker-process form of
    :func:`default_batchify_fn` (CPU NDArrays are read as numpy)."""
    if isinstance(data[0], tuple):
        return tuple(numpy_batchify_fn(list(i)) for i in zip(*data))
    if isinstance(data[0], nd.NDArray):
        data = [d.asnumpy() for d in data]
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return arr


def _nbytes(batch):
    if isinstance(batch, tuple):
        return sum(_nbytes(b) for b in batch)
    return np.asarray(batch).nbytes


def _shm_free():
    """Bytes free in /dev/shm (None where it cannot be read)."""
    try:
        st = os.statvfs("/dev/shm")
    except OSError:
        return None
    return st.f_bavail * st.f_frsize


def _check_fits(batch):
    """Raise ENOSPC for a batch larger than /dev/shm's free space, before
    a block is made (a block written past it kills the worker with
    SIGBUS)."""
    need, free = _nbytes(batch), _shm_free()
    if free is not None and need > free:
        raise OSError(
            errno.ENOSPC,
            f"a {need}-byte batch does not fit in /dev/shm ({free} bytes "
            "free): lower batch_size or prefetch, or enlarge /dev/shm")


def _shm_export(batch, shms):
    """Copy a numpy batch (array or tuple tree) into SharedMemory blocks;
    returns a picklable descriptor (the reference pickles NDArrays through
    shared memory the same way, dataloader.py:134-156)."""
    from multiprocessing import shared_memory

    if isinstance(batch, tuple):
        return ("tuple", [_shm_export(b, shms) for b in batch])
    arr = np.ascontiguousarray(batch)
    shm = shared_memory.SharedMemory(create=True, size=max(arr.nbytes, 1))
    shms.append(shm)
    view = np.ndarray(arr.shape, arr.dtype, buffer=shm.buf)
    view[...] = arr
    return ("array", shm.name, arr.shape, str(arr.dtype))


# A block is registered with the resource tracker once, by the worker
# that makes it, and unregistered once, by the parent that unlinks it; the
# parent maps it without registering it again. So a block whose worker
# dies before the parent holds it is the tracker's to unlink at exit, and
# the tracker never sees an unregister it cannot match.
def _open_block(name):
    """An mmap of the shared-memory block ``name``, not registered."""
    import _posixshmem
    import mmap

    fd = _posixshmem.shm_open("/" + name, os.O_RDWR, mode=0o600)
    try:
        return mmap.mmap(fd, os.fstat(fd).st_size)
    finally:
        os.close(fd)


def _unlink_block(name):
    import _posixshmem
    from multiprocessing import resource_tracker

    _posixshmem.shm_unlink("/" + name)
    resource_tracker.unregister("/" + name, "shared_memory")


def _shm_import(desc, pin):
    """A descriptor's arrays as CPU NDArrays (copied into pinned memory
    with ``pin``), the blocks released."""
    if desc[0] == "tuple":
        return tuple(_shm_import(d, pin) for d in desc[1])
    _, name, shape, dtype = desc
    dtype = np.dtype(dtype)
    buf = _open_block(name)
    try:
        if not pin:
            return host_array(np.ndarray(shape, dtype, buffer=buf).copy())
        keep = {np.dtype(np.float64): np.float32,
                np.dtype(np.int64): np.int32}.get(dtype, dtype)
        out = torch.empty(shape, dtype=torch_dtype(keep), pin_memory=True)
        out.numpy()[...] = np.ndarray(shape, dtype, buffer=buf)
        return nd.NDArray(out, cpu())
    finally:
        buf.close()
        _unlink_block(name)


def _shm_discard(desc):
    """Unlink an unconsumed descriptor's blocks (abandoned iterator)."""
    if desc[0] == "tuple":
        for d in desc[1]:
            _shm_discard(d)
        return
    try:
        _unlink_block(desc[1])
    except FileNotFoundError:
        pass


def _mp_worker(dataset, batchify_fn, conn):
    """Worker-process loop over its own pipe: receive index lists, batchify
    with numpy, ship through shared memory. Runs no CUDA: one intra-op
    thread, and the CPU as the current context."""
    torch.set_num_threads(1)
    with cpu():
        while True:
            try:
                job = conn.recv()
            except EOFError:
                return
            if job is None:
                return
            j, batch_idx = job
            shms = []
            try:
                out = batchify_fn([dataset[i] for i in batch_idx])
                _check_fits(out)
                desc = _shm_export(out, shms)
                for shm in shms:
                    shm.close()
                shms = []           # the parent unlinks them from here
                conn.send((j, "ok", desc))
            except BaseException as e:  # noqa: BLE001 - to the parent
                import traceback

                # a partial export (e.g. /dev/shm exhaustion mid-batch)
                # must not leak the segments already made for this job
                for shm in shms:
                    try:
                        shm.close()
                        shm.unlink()
                    except OSError:
                        pass
                conn.send((j, "error",
                           f"{type(e).__name__}: {e}\n"
                           f"{traceback.format_exc()}"))


def _on_card(x):
    if isinstance(x, nd.NDArray):
        return x.context.device_type != "cpu"
    if isinstance(x, torch.Tensor):
        return x.device.type != "cpu"
    if isinstance(x, (tuple, list)):
        return any(_on_card(i) for i in x)
    return False


class DataLoader:
    """Loads data from a Dataset and returns mini-batches on the context
    current at construction."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=False, timeout=120,
                 max_worker_respawns=None):
        import os as _os

        self._dataset = dataset
        self._timeout = timeout
        if max_worker_respawns is None:
            max_worker_respawns = int(_os.environ.get(
                "MXNET_TPU_TORCH_DATALOADER_RESPAWNS",
                str(max(1, num_workers))))
        self._max_worker_respawns = max(0, max_worker_respawns)
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
        self._thread_pool = thread_pool
        self._num_workers = max(0, num_workers)
        self._mp = self._num_workers > 0 and not thread_pool
        if batchify_fn is None:
            batchify_fn = numpy_batchify_fn if self._mp \
                else default_batchify_fn
        self._batchify_fn = batchify_fn
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._ctx = current_context()
        self._pin = bool(pin_memory) and self._ctx.device_type != "cpu"

    def __len__(self):
        return len(self._batch_sampler)

    def __iter__(self):
        # each next() is spanned as the step timeline's data-wait phase:
        # the time the training loop stalls on input
        it = self._iter_impl()
        while True:
            with _obs_trace.span("step.data_wait"):
                try:
                    batch = self._to_ctx(next(it))
                except StopIteration:
                    return
            _STATS["dataloader_batches"] += 1
            yield batch

    def _to_ctx(self, batch):
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._to_ctx(b) for b in batch)
        if isinstance(batch, np.ndarray):
            batch = host_array(batch)
        if not isinstance(batch, nd.NDArray) or batch.context == self._ctx:
            return batch
        _STATS["dataloader_h2d_copies"] += 1
        _STATS["dataloader_h2d_bytes"] += batch.size * \
            batch._data.element_size()
        if not self._pin or batch.context.device_type != "cpu":
            return batch.as_in_context(self._ctx)
        t = batch._data
        if not t.is_pinned():
            t = t.pin_memory()
        return nd.NDArray(t.to(self._ctx.torch_device(), non_blocking=True),
                          self._ctx)

    def _iter_impl(self):
        if self._num_workers == 0:
            for batch_idx in self._batch_sampler:
                yield self._batchify_fn([self._dataset[i] for i in batch_idx])
            return
        if self._mp and self._fork_safe():
            yield from self._mp_iter()
        else:
            yield from self._threaded_iter()

    def _fork_safe(self):
        """Worker processes must never touch the CUDA context a fork
        inherited: a dataset yielding arrays on the card runs on the
        thread pool instead (one sample probed once)."""
        if not hasattr(self, "_fork_ok"):
            self._fork_ok = len(self._dataset) == 0 or \
                not _on_card(self._dataset[0])
            if not self._fork_ok:
                import warnings

                warnings.warn(
                    "DataLoader: dataset yields arrays on the card, which "
                    "cannot cross a fork — falling back to thread workers. "
                    "Return host arrays from the Dataset (or pass "
                    "thread_pool=True) to silence this.")
                if self._batchify_fn is numpy_batchify_fn:
                    self._batchify_fn = default_batchify_fn
        return self._fork_ok

    def _mp_iter(self):
        """Fork worker processes, each with a pipe of its own; batches
        return through shared memory and become NDArrays in the parent
        (reference multiprocess DataLoader, dataloader.py:533).

        A worker that dies mid-epoch (OOM kill, segfault, SIGKILL) is
        respawned, up to ``max_worker_respawns`` times, and the batches it
        held are resubmitted. A pipe a worker keeps no lock another
        worker waits on, so a death at any point leaves the others
        running. The wait for each batch is bounded by ``timeout`` and
        raises naming the workers.
        """
        import multiprocessing as mp
        import time as _time
        from multiprocessing.connection import wait

        from multiprocessing import resource_tracker

        ctx = mp.get_context("fork")
        resource_tracker.ensure_running()   # one tracker, the workers' too
        batches = list(self._batch_sampler)
        pending: dict[int, object] = {}
        respawns = [0]

        class _Worker:
            def __init__(w):
                w.conn, child = ctx.Pipe()
                w.proc = ctx.Process(target=_mp_worker,
                                     args=(self._dataset, self._batchify_fn,
                                           child), daemon=True)
                w.proc.start()
                child.close()
                w.held = []   # batches sent and not yet answered

        workers = [_Worker() for _ in range(self._num_workers)]

        def submit(j):
            for w in sorted(workers, key=lambda w: len(w.held)):
                try:
                    w.conn.send((j, batches[j]))
                except OSError:     # dead: the next poll replaces it
                    continue
                w.held.append(j)
                return
            raise RuntimeError("DataLoader: no live worker to take batch "
                               f"{j}")

        def accept(w, got_j, status, payload):
            if got_j in w.held:
                w.held.remove(got_j)
            if got_j in pending or got_j < next_j[0]:
                if status == "ok":      # a resubmitted batch's twin
                    _shm_discard(payload)
                return
            if status == "error":
                raise RuntimeError(
                    f"DataLoader worker failed on batch {got_j}: "
                    f"{payload}")
            pending[got_j] = payload

        def drain(w):
            """Take every result ``w`` sent (a dead worker's too: its
            unread blocks would leak, and its batches run twice)."""
            try:
                while w.conn.poll():
                    accept(w, *w.conn.recv())
            except (EOFError, OSError):
                pass

        def replace(w, waiting_for):
            drain(w)
            info = f"pid {w.proc.pid}, exitcode {w.proc.exitcode}"
            if respawns[0] >= self._max_worker_respawns:
                raise RuntimeError(
                    f"DataLoader worker ({info}) died while producing "
                    f"batch ~{waiting_for} and the respawn budget "
                    f"({self._max_worker_respawns}) is exhausted; check "
                    "the dataset __getitem__ for crashes/OOM, or raise "
                    "max_worker_respawns")
            respawns[0] += 1
            _STATS["dataloader_respawns"] += 1
            w.conn.close()
            workers[workers.index(w)] = _Worker()
            import warnings

            warnings.warn(
                f"DataLoader worker ({info}) died mid-epoch; respawned "
                f"(respawn {respawns[0]}/{self._max_worker_respawns})")
            for j in w.held:        # lost with it: run them again
                submit(j)

        def poll(waiting_for):
            """Take whatever the workers sent within a second; replace the
            dead ones."""
            ready = wait([w.conn for w in workers], timeout=1.0)
            for w in list(workers):
                if w.conn in ready:
                    drain(w)
                if not w.proc.is_alive():
                    w.proc.join()
                    replace(w, waiting_for)

        next_j = [0]
        try:
            depth = min(len(batches),
                        self._prefetch or 2 * self._num_workers)
            for submitted in range(depth):
                submit(submitted)
            submitted = depth
            for j in range(len(batches)):
                next_j[0] = j
                for w in list(workers):     # a death while all was ready
                    if not w.proc.is_alive():
                        w.proc.join()
                        replace(w, j)
                deadline = _time.monotonic() + self._timeout
                while j not in pending:
                    poll(j)
                    if j not in pending and _time.monotonic() > deadline:
                        states = ", ".join(
                            f"pid {w.proc.pid}: "
                            f"{'alive' if w.proc.is_alive() else f'dead (exitcode {w.proc.exitcode})'}"
                            for w in workers)
                        raise RuntimeError(
                            f"DataLoader timed out after {self._timeout}s "
                            f"waiting for batch {j} (workers: {states}); "
                            "raise timeout= or check the dataset for a "
                            "hang")
                if submitted < len(batches):
                    submit(submitted)
                    submitted += 1
                next_j[0] = j + 1
                yield _shm_import(pending.pop(j), self._pin)
        finally:
            for w in workers:
                try:
                    w.conn.send(None)
                except OSError:
                    pass
            for w in workers:
                # reclaim the shared memory of batches never consumed
                # (abandoned iterator, error path) while the worker ends
                end = _time.monotonic() + 5
                while w.proc.is_alive() and _time.monotonic() < end:
                    try:
                        if w.conn.poll(0.1):
                            _, status, payload = w.conn.recv()
                            if status == "ok":
                                _shm_discard(payload)
                    except (EOFError, OSError):
                        break
                w.proc.join(timeout=1)
                if w.proc.is_alive():
                    w.proc.terminate()
                    w.proc.join(timeout=5)
                try:
                    while w.conn.poll():
                        _, status, payload = w.conn.recv()
                        if status == "ok":
                            _shm_discard(payload)
                except (EOFError, OSError):
                    pass
                w.conn.close()
            for desc in pending.values():
                _shm_discard(desc)

    def _threaded_iter(self):
        """Ordered prefetch over a thread pool."""
        batches = list(self._batch_sampler)
        results: dict[int, object] = {}
        lock = threading.Lock()
        cond = threading.Condition(lock)
        next_submit = [0]
        depth = self._prefetch or (2 * self._num_workers)
        errors: list[BaseException] = []

        def work(job):
            j, batch_idx = job
            try:
                out = self._batchify_fn([self._dataset[i] for i in batch_idx])
            except BaseException as e:  # propagate to consumer
                with cond:
                    errors.append(e)
                    cond.notify_all()
                return
            with cond:
                results[j] = out
                cond.notify_all()

        jobs = queue.Queue()
        for j, b in enumerate(batches):
            jobs.put((j, b))

        def worker_loop():
            while True:
                try:
                    job = jobs.get_nowait()
                except queue.Empty:
                    return
                # throttle: don't run too far ahead of the consumer
                with cond:
                    while job[0] > next_submit[0] + depth and not errors:
                        cond.wait(0.05)
                    if errors:
                        return
                work(job)

        threads = [threading.Thread(target=worker_loop, daemon=True)
                   for _ in range(self._num_workers)]
        for t in threads:
            t.start()
        try:
            for j in range(len(batches)):
                with cond:
                    while j not in results and not errors:
                        if not cond.wait(self._timeout):
                            raise RuntimeError(
                                f"DataLoader timed out after {self._timeout}s "
                                f"waiting for batch {j}")
                    if errors:
                        raise errors[0]
                    out = results.pop(j)
                    next_submit[0] = j + 1
                    cond.notify_all()
                yield out
        finally:
            with cond:
                errors.append(StopIteration())
                cond.notify_all()
            for t in threads:
                t.join(timeout=1.0)

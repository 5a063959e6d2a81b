"""BatchServer — thread-safe dynamic batching over a Predictor, and
DecodeBatcher — continuous token-level batching over a DecodePredictor
(subset of ``mxnet_tpu/serving/batcher.py``: deadlines, load shedding,
health checks, decode's fault hooks, ``death_sink`` reroute and trace
spans come with later slices).

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

import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError

import numpy as _np
import torch

from ..base import MXNetError
from . import _STATS, record_itl, record_latency, record_ttft

__all__ = ["BatchServer", "ServerClosed", "DecodeBatcher", "TokenStream"]


def _env_float(name, default):
    v = os.environ.get(name, "").strip()
    return float(v) if v else default


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


# --------------------------------------------- continuous token batching

class TokenStream:
    """Consumer handle for one streamed generation: the decode engine
    pushes tokens as they are produced; :meth:`tokens` iterates them as
    they arrive and :meth:`result` collects the completion. ``ttft_s``
    (time to first token) is stamped when the first token lands."""

    def __init__(self):
        self.created = time.perf_counter()
        self.generated = []     # every token pushed
        self.ttft_s = None
        self.finished = False
        self.reason = None
        self.cancelled = False
        self._q = queue.Queue()

    def _push(self, tok):
        self.generated.append(int(tok))
        self._q.put(("token", int(tok)))

    def _finish(self, reason):
        self.finished = True
        self.reason = reason
        self._q.put(("done", reason))

    def _fail(self, exc):
        self.finished = True
        self.reason = "error"
        self._q.put(("error", exc))

    def cancel(self):
        """Ask the engine to evict this sequence at its next step; its
        pages are freed at the eviction."""
        self.cancelled = True

    def tokens(self, timeout=None):
        """Generator over the stream's tokens in order; returns when the
        sequence finishes, raises the engine's error if it failed."""
        while True:
            kind, val = self._q.get(timeout=timeout)
            if kind == "token":
                yield val
            elif kind == "done":
                return
            else:
                raise val

    def __iter__(self):
        return self.tokens()

    def result(self, timeout=None):
        """Block until the stream finishes; returns the full token list."""
        for _ in self.tokens(timeout=timeout):
            pass
        return list(self.generated)


class _DecodeSeq:
    __slots__ = ("prompt", "max_new", "eos_id", "stream", "pages", "row",
                 "pos", "generated", "t_last", "preempts")

    def __init__(self, prompt, max_new, eos_id, stream):
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.stream = stream
        self.pages = []
        self.row = None
        self.pos = 0            # next KV write position
        self.generated = []     # tokens produced since the last (re)admit
        self.t_last = 0.0
        self.preempts = 0


def _try_resolve_stream(stream, exc):
    if not stream.finished:
        stream._fail(exc)


class DecodeBatcher:
    """Continuous token-level batching over a :class:`DecodePredictor`.

    One engine thread runs the fixed-shape decode step in a loop over
    ``max_seqs`` slots. A sequence is admitted into a free slot between
    steps (a bucketed prefill writes its prompt's KV, then it joins the
    next step) and evicted the moment it finishes, so no sequence waits for
    a batch to drain. Admission is where page backpressure lands: a prompt
    whose pages the pool cannot supply waits (``decode_backpressure``
    counts refusals); a LIVE sequence that outgrows its pages while the pool
    is dry is preempted -- pages freed, re-queued at the front for a
    re-prefill of prompt + generated (``decode_preemptions``) -- and fails
    cleanly after more than 3 preemptions instead of livelocking.

    TTFT (submit -> first token, prefill included) is checked against
    ``ttft_slo_ms`` (default ``MXNET_TPU_TORCH_DECODE_TTFT_SLO_MS``, 500)
    in ``decode_ttft_misses``; every inter-token gap goes to the ITL
    window (``serving.stats()``).
    """

    def __init__(self, predictor, ttft_slo_ms=None):
        self.predictor = predictor
        self.ttft_slo_s = (
            ttft_slo_ms if ttft_slo_ms is not None
            else _env_float("MXNET_TPU_TORCH_DECODE_TTFT_SLO_MS", 500.0)
        ) / 1e3
        self._pending = deque()
        self._live = {}          # row -> _DecodeSeq
        self._free_rows = list(range(predictor.max_seqs))
        self._table = _np.zeros((predictor.max_seqs, predictor.max_pages),
                                _np.int32)
        self._cond = threading.Condition()
        self._closed = False
        self._engine_thread = threading.Thread(
            target=self._engine_loop, name="mxnet-torch-decode", daemon=True)
        self._engine_thread.start()

    # ------------------------------------------------------------ intake
    def submit(self, prompt, max_new_tokens, eos_id=None):
        """Queue one generation request; returns its :class:`TokenStream`."""
        prompt = [int(t) for t in prompt]
        max_len = self.predictor._spec["max_len"]
        if not prompt or len(prompt) >= max_len:
            raise MXNetError(f"decode prompt length must be 1.."
                             f"{max_len - 1}, got {len(prompt)}")
        if int(max_new_tokens) < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        stream = TokenStream()
        seq = _DecodeSeq(prompt, max_new_tokens, eos_id, stream)
        with self._cond:
            if self._closed:
                raise ServerClosed("DecodeBatcher is closed")
            self._pending.append(seq)
            self._cond.notify_all()
        return stream

    # ------------------------------------------------------------ engine
    def _engine_loop(self):
        try:
            while True:
                with self._cond:
                    while (not self._pending and not self._live
                           and not self._closed):
                        self._cond.wait()
                    if self._closed and not self._live:
                        leftovers = list(self._pending)
                        self._pending.clear()
                        self._cond.notify_all()
                        for s in leftovers:
                            _try_resolve_stream(s.stream, ServerClosed(
                                "DecodeBatcher closed before admission"))
                        return
                self._admit()
                if not self._step_once():
                    # nothing live: pending blocked on pages (or closing)
                    with self._cond:
                        if self._pending and not self._closed:
                            self._cond.wait(0.005)
        except BaseException as e:
            self._die(ServerClosed(
                f"decode engine died: {type(e).__name__}: {e}"))
            raise

    def _admit(self):
        ps = self.predictor.page_size
        while True:
            with self._cond:
                if self._closed or not self._pending or \
                        not self._free_rows:
                    return
                seq = self._pending[0]
                if seq.stream.cancelled:
                    self._pending.popleft()
                    _STATS["decode_evictions"] += 1
                    seq.stream._finish("cancelled")
                    continue
                ctx = seq.prompt + seq.generated
                # pages for the full context plus the next written token
                need = -(-(len(ctx) + 1) // ps)
                pages = self.predictor.pool.alloc(need)
                if pages is None:
                    return  # backpressure: wait for evictions
                self._pending.popleft()
                row = self._free_rows.pop()
            try:
                seq.pages = list(pages)
                seq.row = row
                self._table[row, :] = 0
                self._table[row, :len(pages)] = pages
                first, _ = self.predictor.prefill(ctx, self._table[row])
                seq.pos = len(ctx)
                _STATS["decode_sequences"] += 1
                self._emit(seq, first, time.perf_counter())
                if not seq.stream.finished:
                    with self._cond:
                        self._live[row] = seq
                        self._cond.notify_all()
            except Exception as e:
                self._release(seq)
                seq.stream._fail(e)
                _STATS["decode_evictions"] += 1

    def _emit(self, seq, tok, now):
        """Deliver one token: stream push, TTFT or ITL, finish checks."""
        t0 = seq.t_last or seq.stream.created
        seq.generated.append(int(tok))
        seq.stream._push(tok)
        _STATS["decode_tokens"] += 1
        if seq.stream.ttft_s is None:
            ttft = now - seq.stream.created
            seq.stream.ttft_s = ttft
            record_ttft(ttft)
            if ttft > self.ttft_slo_s:
                _STATS["decode_ttft_misses"] += 1
        else:
            record_itl(now - t0)
        seq.t_last = now
        hit_eos = seq.eos_id is not None and int(tok) == seq.eos_id
        if (len(seq.generated) >= seq.max_new or hit_eos
                or seq.pos >= self.predictor._spec["max_len"]):
            self._evict(seq, "eos" if hit_eos else "length")

    def _evict(self, seq, reason):
        self._release(seq)
        _STATS["decode_evictions"] += 1
        seq.stream._finish(reason)

    def _release(self, seq):
        """Return a sequence's pages and slot."""
        if seq.pages:
            self.predictor.pool.free(seq.pages)
            seq.pages = []
        if seq.row is not None:
            self._table[seq.row, :] = 0
            with self._cond:
                self._live.pop(seq.row, None)
                self._free_rows.append(seq.row)
                self._cond.notify_all()
            seq.row = None

    def _preempt(self, seq):
        """A live sequence outgrew its pages and the pool is dry: free what
        it holds and re-queue it first for a re-prefill of prompt +
        generated; streamed tokens stay streamed. More than 3 preemptions
        fail the stream: the pool cannot hold the context."""
        self._release(seq)
        seq.preempts += 1
        if seq.preempts > 3:
            _STATS["decode_evictions"] += 1
            seq.stream._fail(MXNetError(
                "decode KV page pool cannot hold this context "
                f"(preempted {seq.preempts - 1} times; "
                f"{self.predictor.pool.num_pages} pages of "
                f"{self.predictor.page_size} tokens)"))
            return
        seq.prompt = seq.prompt + seq.generated
        seq.max_new -= len(seq.generated)
        seq.generated = []
        _STATS["decode_preemptions"] += 1
        with self._cond:
            self._pending.appendleft(seq)

    def _step_once(self):
        with self._cond:
            live = dict(self._live)
        if not live:
            return False
        ps = self.predictor.page_size
        max_len = self.predictor._spec["max_len"]
        for row, seq in list(live.items()):
            if seq.stream.cancelled:
                self._evict(seq, "cancelled")
                live.pop(row)
                continue
            if seq.pos >= max_len:
                self._evict(seq, "length")
                live.pop(row)
                continue
            if seq.pos >= len(seq.pages) * ps:
                extra = self.predictor.pool.alloc(1)
                if extra is None:
                    self._preempt(seq)
                    live.pop(row)
                    continue
                self._table[row, len(seq.pages)] = extra[0]
                seq.pages.extend(extra)
        if not live:
            return True  # did work (evictions, preemptions)
        n = self.predictor.max_seqs
        toks = _np.zeros((n,), _np.int32)
        positions = _np.zeros((n,), _np.int32)
        active = _np.zeros((n,), _np.int32)
        for row, seq in live.items():
            toks[row] = seq.generated[-1] if seq.generated else \
                seq.prompt[-1]
            positions[row] = seq.pos
            active[row] = 1
        nxt, _ = self.predictor.step(toks, positions, active, self._table)
        now = time.perf_counter()
        for row, seq in live.items():
            seq.pos += 1
            self._emit(seq, int(nxt[row]), now)
        return True

    def _die(self, exc):
        """The engine is gone: every page back to the pool, every
        incomplete stream failed, so no consumer blocks forever."""
        with self._cond:
            self._closed = True
            victims = list(self._live.values()) + list(self._pending)
            self._live.clear()
            self._pending.clear()
            self._cond.notify_all()
        for seq in victims:
            if seq.pages:
                self.predictor.pool.free(seq.pages)
                seq.pages = []
            _try_resolve_stream(seq.stream, exc)

    # ------------------------------------------------------------- close
    def close(self, drain=True, timeout=30.0):
        """Stop intake; with ``drain`` let LIVE sequences finish (pending
        ones fail: a drain that admitted new work would never end), else
        evict everything at the next step."""
        with self._cond:
            self._closed = True
            if not drain:
                for seq in list(self._live.values()) + list(self._pending):
                    seq.stream.cancel()
            self._cond.notify_all()
        self._engine_thread.join(timeout)
        with self._cond:
            leftovers = list(self._live.values()) + list(self._pending)
            self._live.clear()
            self._pending.clear()
        for seq in leftovers:
            if seq.pages:
                self.predictor.pool.free(seq.pages)
                seq.pages = []
            _try_resolve_stream(seq.stream, ServerClosed(
                "DecodeBatcher closed before the stream finished"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=exc[0] is None)

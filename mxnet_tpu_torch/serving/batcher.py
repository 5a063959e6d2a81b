"""BatchServer — thread-safe dynamic batching over a Predictor, and
DecodeBatcher — continuous token-level batching over a DecodePredictor
(port of ``mxnet_tpu/serving/batcher.py``).

``submit(batch, deadline_ms=)`` enqueues and returns a
``concurrent.futures.Future``; a background worker pops requests,
coalesces up to ``max_batch_size`` rows or until ``batch_timeout_ms``
after the oldest request arrived, runs ONE ``predict`` on the fused batch
(which pads it to the Predictor's nearest bucket), and hands each future
exactly its own rows. Only requests of the same per-row shape and dtype
coalesce; a mixed queue batches in arrival order. On a CUDA predictor the
worker waits for the device before it resolves the futures, so a
request's recorded latency ends when its results exist.

- A request whose deadline passes while queued fails with
  :class:`DeadlineExceeded` and is never executed (expired requests are
  pruned before every batch forms); a spent budget fails at admission.
- At ``max_queue_depth`` the queue sheds with :class:`ServerOverloaded`:
  ``reject_new`` fails the incoming request, ``reject_oldest`` the head.
- Every batch runs under the ``batch`` watchdog
  (``MXNET_TPU_TORCH_WATCHDOG_BATCH_TIMEOUT``) and its outputs pass a
  :class:`~mxnet_tpu_torch.resilience.HealthSentinel` (one finiteness
  reduction on the device): a poisoned or stalled batch fails only its
  own requests with ``NumericHealthError`` / ``StallError`` and the
  queue keeps serving.
- The decode engine's fault hooks (``decode_replica_death``) and its
  ``death_sink`` hand a dead engine's streams to another replica
  (``serving.StreamRouter``).

Settings default from ``MXNET_TPU_TORCH_SERVING_MAX_BATCH``,
``_TIMEOUT_MS`` (2.0), ``_QUEUE_DEPTH`` (1024), ``_SHED_POLICY``
(``reject_new``), ``_DEADLINE_MS`` (off) and ``_HEALTH`` (``skip_batch``),
the port's names for ``mxnet_tpu``'s knobs and their defaults.
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
from ..observability import trace as _obs_trace
from ..resilience import faults as _faults
from ..resilience import watchdog as _watchdog
from ..resilience.sentinel import HealthSentinel, NumericHealthError
from . import _STATS, record_itl, record_latency, record_ttft

__all__ = ["BatchServer", "DeadlineExceeded", "ServerOverloaded",
           "ServerClosed", "DecodeBatcher", "TokenStream"]


def _env_float(name, default):
    v = os.environ.get(name, "").strip()
    return float(v) if v else default


def _env_int(name, default):
    v = os.environ.get(name, "").strip()
    return int(v) if v else default


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before execution started."""


class ServerOverloaded(RuntimeError):
    """The request was shed at the queue high-water mark."""


class ServerClosed(RuntimeError):
    """The server is closed (or closing without drain)."""


class _Request:
    __slots__ = ("feeds", "rows", "sig", "future", "t_submit", "deadline",
                 "ctx")

    def __init__(self, feeds, rows, sig, deadline):
        self.feeds = feeds
        self.rows = rows
        self.sig = sig
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = deadline  # absolute perf_counter time, or None
        # the submitter's trace context: the worker re-enters it so the
        # batch's spans parent under the request / attempt span
        self.ctx = _obs_trace.current()


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


def _failed(exc):
    fut = Future()
    fut.set_exception(exc)
    return fut


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
    max_queue_depth : int — queued requests before shedding (default 1024).
    shed_policy : 'reject_new' | 'reject_oldest'.
    default_deadline_ms : the deadline of a request that gives none
        (default off).
    sentinel : HealthSentinel of the outputs (default: policy
        ``MXNET_TPU_TORCH_SERVING_HEALTH`` or 'skip_batch');
        ``check_health=False`` skips the check.
    """

    SHED_POLICIES = ("reject_new", "reject_oldest")

    def __init__(self, predictor, max_batch_size=None, batch_timeout_ms=None,
                 max_queue_depth=None, shed_policy=None,
                 default_deadline_ms=None, sentinel=None, check_health=True):
        self.predictor = predictor
        self.max_batch_size = int(
            max_batch_size if max_batch_size is not None
            else _env_int("MXNET_TPU_TORCH_SERVING_MAX_BATCH",
                          max(predictor.buckets)))
        self.batch_timeout_s = (
            batch_timeout_ms if batch_timeout_ms is not None
            else _env_float("MXNET_TPU_TORCH_SERVING_TIMEOUT_MS", 2.0)) / 1e3
        self.max_queue_depth = int(
            max_queue_depth if max_queue_depth is not None
            else _env_int("MXNET_TPU_TORCH_SERVING_QUEUE_DEPTH", 1024))
        self.shed_policy = (shed_policy or os.environ.get(
            "MXNET_TPU_TORCH_SERVING_SHED_POLICY", "reject_new"))
        if self.shed_policy not in self.SHED_POLICIES:
            raise ValueError(f"shed_policy must be one of "
                             f"{self.SHED_POLICIES}, got {self.shed_policy!r}")
        dms = (default_deadline_ms if default_deadline_ms is not None
               else _env_float("MXNET_TPU_TORCH_SERVING_DEADLINE_MS", 0.0))
        self.default_deadline_s = dms / 1e3 if dms else None
        if check_health:
            self.sentinel = sentinel or HealthSentinel(
                policy=os.environ.get("MXNET_TPU_TORCH_SERVING_HEALTH",
                                      "skip_batch"))
        else:
            self.sentinel = None
        self._queue = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._drain = True
        self._inflight = ()  # the batch executing now (close() fails it)
        self._worker = threading.Thread(target=self._serve_loop,
                                        name="mxnet-torch-serving",
                                        daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ intake
    def submit(self, data, deadline_ms=None):
        """Enqueue one request (array/tensor or dict name -> array, WITH the
        batch axis; 1..max_batch_size rows) with an optional deadline.
        Returns a Future resolving to the list of output tensors for
        exactly those rows. Inputs are copied to the predictor's device
        here, so the caller may reuse its buffers once submit returns."""
        # shed before the input copy: under sustained overload a doomed
        # request must not pay for its copy just to be rejected
        with self._cond:
            if self._closed:
                raise ServerClosed("BatchServer is closed")
            if len(self._queue) >= self.max_queue_depth and \
                    self.shed_policy == "reject_new":
                _STATS["serving_shed_overload"] += 1
                return _failed(ServerOverloaded(
                    f"queue depth {len(self._queue)} at high-water "
                    f"mark {self.max_queue_depth}"))
        if deadline_ms is not None:
            if deadline_ms <= 0:
                _STATS["serving_shed_deadline"] += 1
                return _failed(DeadlineExceeded(
                    f"deadline budget ({deadline_ms:.3g}ms) already spent "
                    "at admission"))
            deadline = time.perf_counter() + deadline_ms / 1e3
        elif self.default_deadline_s is not None:
            deadline = time.perf_counter() + self.default_deadline_s
        else:
            deadline = None
        feeds, rows = self.predictor._coerce_feeds(data)
        feeds = {name: a.clone() for name, a in feeds.items()}
        if rows < 1 or rows > self.max_batch_size:
            raise MXNetError(f"request rows must be 1..{self.max_batch_size}"
                             f", got {rows}")
        req = _Request(feeds, rows, self.predictor._sig_of(feeds), deadline)
        with self._cond:
            if self._closed:
                raise ServerClosed("BatchServer is closed")
            if len(self._queue) >= self.max_queue_depth:
                _STATS["serving_shed_overload"] += 1
                if self.shed_policy == "reject_new":
                    req.future.set_exception(ServerOverloaded(
                        f"queue depth {len(self._queue)} at high-water "
                        f"mark {self.max_queue_depth}"))
                    return req.future
                oldest = self._queue.popleft()
                _try_resolve(oldest.future, exc=ServerOverloaded(
                    "shed by a newer request (reject_oldest)"))
            self._queue.append(req)
            _STATS["serving_requests"] += 1
            _STATS["serving_queue_peak"] = max(_STATS["serving_queue_peak"],
                                               len(self._queue))
            self._cond.notify_all()
        return req.future

    @property
    def queue_depth(self):
        with self._cond:
            return len(self._queue)

    @property
    def outstanding(self):
        """Queued + in-flight requests (the router's balancing signal)."""
        with self._cond:
            return len(self._queue) + len(self._inflight)

    # ------------------------------------------------------------------ worker
    def _prune_expired(self):
        """Fail every queued request whose deadline passed (under the
        lock), so dead work neither fills the size trigger nor rides in a
        batch."""
        if not any(r.deadline is not None for r in self._queue):
            return
        now = time.perf_counter()
        kept = deque()
        for r in self._queue:
            if r.deadline is not None and now > r.deadline:
                _STATS["serving_shed_deadline"] += 1
                _try_resolve(r.future, exc=DeadlineExceeded(
                    f"deadline passed {(now - r.deadline) * 1e3:.2f}ms "
                    "before execution"))
            else:
                kept.append(r)
        self._queue = kept

    def _take_batch(self):
        """Pop the next run of same-signature requests (total rows <=
        max_batch_size), honouring the time trigger. None when closed and
        drained."""
        with self._cond:
            while True:
                self._prune_expired()
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
                # wake at the flush or the next queued deadline
                t_wake = t_flush
                for r in self._queue:
                    if r.deadline is not None and r.deadline < t_wake:
                        t_wake = r.deadline
                self._cond.wait(max(0.0, t_wake - now))

    def _serve_loop(self):
        """The serve loop; if it dies (a BaseException such as an
        interpreter teardown), every admitted future fails with
        ServerClosed before the thread exits."""
        try:
            self._serve()
        except BaseException as e:
            with self._cond:
                self._closed = True
                leftovers = list(self._queue) + list(self._inflight)
                self._queue.clear()
                self._inflight = ()
                self._cond.notify_all()
            err = ServerClosed(
                f"BatchServer worker died: {type(e).__name__}: {e}")
            for r in leftovers:
                _try_resolve(r.future, exc=err)
            raise

    def _serve(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            self._dispatch(batch)
            # an idle worker must not pin the last batch's inputs and
            # results while it waits for the next one
            del batch

    def _dispatch(self, batch):
        if not self._drain:
            for r in batch:
                _try_resolve(r.future, exc=ServerClosed(
                    "BatchServer closed without drain"))
            return
        # time passes between the pop and the launch
        now = time.perf_counter()
        live = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                _STATS["serving_shed_deadline"] += 1
                _try_resolve(r.future, exc=DeadlineExceeded(
                    f"deadline passed {(now - r.deadline) * 1e3:.2f}ms "
                    "before execution"))
            else:
                live.append(r)
        if live:
            self._execute(live)

    def _run_batch(self, batch, rows):
        """The batch under its watchdog: fused inputs through the
        predictor, then the device wait. Returns (outputs, n)."""
        with _watchdog.guard(
                "batch", detail=f"BatchServer batch ({rows} rows, "
                                f"{len(batch)} request(s))"):
            _faults.maybe_hang("hang_batch")
            fused = {name: (batch[0].feeds[name] if len(batch) == 1 else
                            torch.cat([r.feeds[name] for r in batch], dim=0))
                     for name in batch[0].feeds}
            with _obs_trace.span("serve.execute"):
                outs, n = self.predictor.predict_raw(fused)
                device = getattr(self.predictor, "device", None)
                if device is not None and device.type == "cuda":
                    torch.cuda.current_stream(device).synchronize()
        return outs, n

    def _execute(self, batch):
        with self._cond:
            self._inflight = tuple(batch)
        rows = sum(r.rows for r in batch)
        bsp = None
        try:
            with _obs_trace.context(batch[0].ctx), \
                    _obs_trace.span("serve.batch", rows=rows,
                                    requests=len(batch)) as bsp:
                t0_ns = int(batch[0].t_submit * 1e9)
                _obs_trace.record("serve.batch_form", t0_ns,
                                  max(0, time.perf_counter_ns() - t0_ns))
                outs, n = self._run_batch(batch, rows)
                if self.sentinel is not None:
                    tag = getattr(self.predictor, "quant_tag", "")
                    with _obs_trace.span("serve.sentinel"):
                        try:
                            healthy = self.sentinel.check_finite(
                                outs, what=f"serving batch outputs{tag}")
                            err = None
                        except NumericHealthError as e:
                            healthy, err = False, e
                    if not healthy:
                        _STATS["serving_poisoned_batches"] += 1
                        err = err or NumericHealthError(
                            self.sentinel.last_reason or
                            "non-finite values in serving batch outputs")
                        for r in batch:
                            _try_resolve(r.future, exc=err)
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
        except Exception as e:  # fail this batch, keep the queue serving
            if isinstance(e, _watchdog.StallError):
                _STATS["serving_stalled_batches"] += 1
            for r in batch:
                _try_resolve(r.future, exc=e)
        except BaseException as e:
            # the worker itself is dying: this batch's futures resolve
            # before the unwind clears _inflight
            err = ServerClosed(f"BatchServer worker died mid-batch: "
                               f"{type(e).__name__}: {e}")
            for r in batch:
                _try_resolve(r.future, exc=err)
            raise
        finally:
            if bsp is not None and bsp.ctx is not None and len(batch) > 1:
                # the batch span parents under the head request only;
                # each follower gets a serve.coalesced span in its own tree
                dur_ns = time.perf_counter_ns() - bsp.t0_ns
                for r in batch[1:]:
                    if r.ctx is not None and r.ctx != batch[0].ctx:
                        _obs_trace.record(
                            "serve.coalesced", bsp.t0_ns, dur_ns,
                            parent=r.ctx, batch_trace=bsp.trace_id,
                            rows=rows, requests=len(batch))
            with self._cond:
                self._inflight = ()

    # ------------------------------------------------------------------- close
    def close(self, drain=True, timeout=None):
        """Stop intake; with ``drain`` (default) serve every queued request
        first, otherwise fail them with ServerClosed. Idempotent.

        The drain is bounded: ``timeout`` (seconds; default from the batch
        watchdog deadline times the pending batches, else unbounded)
        caps the wait, after which the queued and in-flight requests fail
        with :class:`ServerClosed` instead of leaking."""
        with self._cond:
            self._closed = True
            self._drain = self._drain and drain
            pending_rows = sum(r.rows for r in self._queue)
            inflight = 1 if self._inflight else 0
            self._cond.notify_all()
        if timeout is None:
            per_batch = _watchdog.timeout_for("batch")
            if per_batch is not None:
                batches = -(-pending_rows // self.max_batch_size) + inflight
                timeout = per_batch * max(1, batches) + 1.0
        self._worker.join(timeout)
        with self._cond:
            leftovers = list(self._queue) + list(self._inflight)
            if leftovers:
                self._drain = False
                self._queue.clear()
                self._cond.notify_all()
        if not leftovers:
            return
        err = ServerClosed(
            "BatchServer drain exceeded its shutdown deadline "
            f"({timeout:.3g}s); request abandoned at close"
            if self._worker.is_alive() else
            "BatchServer worker died before draining; request abandoned "
            "at close")
        for r in leftovers:
            _try_resolve(r.future, exc=err)
        self._worker.join(0.1)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=exc[0] is None)


# --------------------------------------------- continuous token batching

class TokenStream:
    """Consumer handle for one streamed generation: the decode engine
    pushes tokens as they are produced; :meth:`tokens` iterates them as
    they arrive and :meth:`result` collects the completion. ``ttft_s``
    (time to first token) is stamped when the first token lands;
    ``generated`` holds every token, across reroutes, so a fleet reroute
    can resume the stream on another replica mid-completion."""

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
        self.generated = []     # tokens THIS engine produced (the stream
        self.t_last = 0.0       # may carry more, from before a reroute)
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

    ``decode_replica_death`` raises inside the engine loop: every live and
    pending stream is handed to ``death_sink`` (the fleet's StreamRouter
    installs one) or failed with the error, and every page returns to the
    pool.
    """

    def __init__(self, predictor, ttft_slo_ms=None):
        self.predictor = predictor
        self.ttft_slo_s = (
            ttft_slo_ms if ttft_slo_ms is not None
            else _env_float("MXNET_TPU_TORCH_DECODE_TTFT_SLO_MS", 500.0)
        ) / 1e3
        self.death_sink = None   # callable(list of (stream, prompt,
        self.dead = False        #   remaining_max_new, eos_id), exc)
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
    def submit(self, prompt, max_new_tokens, eos_id=None, stream=None):
        """Queue one generation request; returns its :class:`TokenStream`
        (or continues the one passed in: the fleet's reroute)."""
        prompt = [int(t) for t in prompt]
        max_len = self.predictor._spec["max_len"]
        if not prompt or len(prompt) >= max_len:
            raise MXNetError(f"decode prompt length must be 1.."
                             f"{max_len - 1}, got {len(prompt)}")
        if int(max_new_tokens) < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        stream = stream if stream is not None else TokenStream()
        seq = _DecodeSeq(prompt, max_new_tokens, eos_id, stream)
        with self._cond:
            if self._closed:
                raise ServerClosed("DecodeBatcher is closed")
            self._pending.append(seq)
            self._cond.notify_all()
        return stream

    @property
    def outstanding(self):
        with self._cond:
            return len(self._pending) + len(self._live)

    @property
    def live_count(self):
        with self._cond:
            return len(self._live)

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
                _faults.maybe_decode_replica_death()
                self._admit()
                if not self._step_once():
                    # nothing live: pending blocked on pages (or closing)
                    with self._cond:
                        if self._pending and not self._closed:
                            self._cond.wait(0.005)
        except _faults.DecodeReplicaDead as e:
            self._die(e, reroute=True)
        except BaseException as e:
            self._die(ServerClosed(
                f"decode engine died: {type(e).__name__}: {e}"),
                reroute=False)
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
                with _obs_trace.span("decode.admit", row=row,
                                     ctx=len(ctx), pages=need):
                    seq.pages = list(pages)
                    seq.row = row
                    self._table[row, :] = 0
                    self._table[row, :len(pages)] = pages
                    first, _ = self.predictor.prefill(ctx,
                                                      self._table[row])
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
        _obs_trace.record("decode.token", int(t0 * 1e9),
                          max(0, int((now - t0) * 1e9)), row=seq.row,
                          position=seq.pos)
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

    def _die(self, exc, reroute):
        """The engine is gone: every page back to the pool, then each
        incomplete stream handed to ``death_sink`` (``reroute``) or
        failed, so no page leaks and no consumer blocks forever."""
        with self._cond:
            self.dead = True
            self._closed = True
            victims = list(self._live.values()) + list(self._pending)
            self._live.clear()
            self._pending.clear()
            self._cond.notify_all()
        for seq in victims:
            if seq.pages:
                self.predictor.pool.free(seq.pages)
                seq.pages = []
        sink = self.death_sink if reroute else None
        if sink is not None:
            items = [(s.stream, s.prompt + s.generated,
                      s.max_new - len(s.generated), s.eos_id)
                     for s in victims
                     if not s.stream.finished and
                     s.max_new - len(s.generated) > 0]
            for s in victims:
                if not s.stream.finished and \
                        s.max_new - len(s.generated) <= 0:
                    s.stream._finish("length")
            try:
                sink(items, exc)
                return
            except Exception:
                pass  # fail what the sink did not take
        for seq in victims:
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

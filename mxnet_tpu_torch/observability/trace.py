"""Structured span tracing (port of ``mxnet_tpu/observability/trace.py``).

One *span* is one timed phase of work (``perf_counter_ns`` start and end)
with a name, flat attributes and a place in a tree: every span carries
the ``trace_id`` of its root and the ``span_id`` of its parent, held in a
thread-local context that nests with the ``with`` statement. The serving
runtime's spans:

- ``serve.request`` > ``serve.attempt`` > ``serve.batch`` >
  ``serve.batch_form`` / ``serve.execute`` (> ``serve.predict``) /
  ``serve.sentinel``; ``serve.coalesced`` for a batch's followers;
  ``serve.replica`` inside a process replica;
- ``decode.admit`` > ``decode.prefill``, ``decode.step``,
  ``decode.predict``, ``decode.token``;
- ``rollout.weights`` > ``rollout.canary`` / ``rollout.gate.*`` /
  ``rollout.rollback`` / ``rollout.promote``.

A producer captures :func:`current` and a consumer re-enters it with
:func:`context`. Across the fleet's process-replica pipe the context ships
with the request and the child's records ship back with the reply
(:func:`collect` in the child, :func:`ingest` in the parent).

Tracing is off by default (``MXNET_TPU_TORCH_OBS_TRACE=1`` or
:func:`set_enabled`): a disabled ``trace.span(...)`` returns one shared
no-op context manager. Ended spans land in a ring of
``MXNET_TPU_TORCH_OBS_SPAN_RING`` records (default 4096); root-span ends
also feed the flight recorder and the ``mxnet_tpu_span_ms`` histogram.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

from collections import deque

from . import _STATS, flight as _flight
from . import metrics as _metrics

__all__ = ["span", "start_span", "record", "current", "context",
           "collect", "ingest", "spans", "roots", "clear", "enabled",
           "set_enabled", "new_trace_id", "Span"]

try:
    _RING_SIZE = int(os.environ.get("MXNET_TPU_TORCH_OBS_SPAN_RING", "4096"))
except ValueError:
    _RING_SIZE = 4096
_RING_LOCK = threading.Lock()
_RING = deque(maxlen=max(1, _RING_SIZE))

_ENABLED = os.environ.get("MXNET_TPU_TORCH_OBS_TRACE", "").strip() in (
    "1", "true", "on", "yes")

_TLS = threading.local()
_IDS = itertools.count(1)
# pid + a random salt disambiguate ids across processes (spawned fleet
# replicas ship their span records back over the pipe) and pid reuse.
# Both are cached at import: ids are built on the span hot path.
_SALT = os.urandom(2).hex()
_PID_HEX = f"{os.getpid():x}"


def enabled():
    return _ENABLED


def set_enabled(flag):
    """Turn span tracing on/off at runtime (the post-import counterpart
    of ``MXNET_TPU_TORCH_OBS_TRACE``); returns the previous state."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(flag)
    return prev


def new_trace_id():
    return f"{_SALT}{_PID_HEX}-{next(_IDS):x}"


def _new_span_id():
    return f"{_PID_HEX}.{next(_IDS):x}"


def current():
    """The active context as ``(trace_id, span_id)``, or None. This is
    the token a producer hands a consumer thread (or ships over a pipe)
    so work done elsewhere parents correctly."""
    return getattr(_TLS, "ctx", None)


class Span:
    """One open span. Usually managed by ``with trace.span(...)``; the
    router uses :func:`start_span` + :meth:`end` explicitly because a
    request span outlives the submitting thread."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "attrs",
                 "t0_ns", "_prev_ctx", "_entered", "_done")

    def __init__(self, name, parent_ctx, attrs):
        if parent_ctx is None:
            self.trace_id = new_trace_id()
            self.parent_id = None
        else:
            self.trace_id, self.parent_id = parent_ctx
        self.span_id = _new_span_id()
        self.name = name
        self.attrs = attrs
        self.t0_ns = time.perf_counter_ns()
        self._prev_ctx = None
        self._entered = False
        self._done = False

    @property
    def ctx(self):
        return (self.trace_id, self.span_id)

    def set(self, **attrs):
        """Attach attributes after the fact (outcome, row counts)."""
        self.attrs.update(attrs)
        return self

    def end(self, **attrs):
        """Close the span and place its record in the ring. Idempotent
        (a router request span may race its own expiry action)."""
        if self._done:
            return
        self._done = True
        if attrs:
            self.attrs.update(attrs)
        dur = time.perf_counter_ns() - self.t0_ns
        rec = {"trace": self.trace_id, "span": self.span_id,
               "parent": self.parent_id, "name": self.name,
               "t0_ns": self.t0_ns, "dur_ns": dur,
               "thread": threading.current_thread().name,
               "attrs": self.attrs}
        _store(rec)
        if self.parent_id is None:
            # scalar attrs ride into the flight event, minus the keys
            # the event itself owns (an attr literally named "name"/
            # "trace"/"dur_ns" must not TypeError the span end)
            extra = {k: v for k, v in self.attrs.items()
                     if isinstance(v, (int, float, str))
                     and k not in ("name", "trace", "dur_ns",
                                   "kind", "seq", "t", "ns")}
            _flight.record("span", name=self.name, trace=self.trace_id,
                           dur_ns=dur, **extra)
        _metrics.note_span(self.name, dur)

    # -- context-manager form: nest via the thread-local context
    def __enter__(self):
        self._prev_ctx = getattr(_TLS, "ctx", None)
        _TLS.ctx = self.ctx
        self._entered = True
        return self

    def __exit__(self, exc_type, exc, tb):
        _TLS.ctx = self._prev_ctx
        if exc_type is not None and "error" not in self.attrs:
            self.attrs["error"] = exc_type.__name__
        self.end()
        return False


class _NoopSpan:
    """Shared do-nothing span: the entire disabled-path cost of an
    instrumented site is building this module's function call and one
    global check."""

    __slots__ = ()
    trace_id = span_id = parent_id = None
    ctx = None

    def set(self, **attrs):
        return self

    def end(self, **attrs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NOOP = _NoopSpan()


def _tracing_here():
    """Tracing is live on this thread: globally enabled, or force-traced
    by a shipped context (a process replica serving a traced request
    while its own global flag is off)."""
    return _ENABLED or getattr(_TLS, "force", False)


def span(name, **attrs):
    """Open one span as a context manager, parented under the calling
    thread's current context. No-op (shared instance) when tracing is
    off — safe to leave on every hot path."""
    if not _tracing_here():
        return _NOOP
    return Span(name, current(), attrs)


def start_span(name, parent=None, **attrs):
    """Open a span WITHOUT touching the thread-local context — for
    lifetimes that end on another thread (the router's per-request and
    per-attempt spans end in future callbacks). ``parent`` is a
    ``(trace_id, span_id)`` context; None parents under the caller's
    current context (or roots a new trace)."""
    if not _tracing_here():
        return _NOOP
    return Span(name, parent if parent is not None else current(), attrs)


def record(name, t0_ns, dur_ns, parent=None, **attrs):
    """Record a span retroactively from measured timestamps (the
    batcher's batch-form wait is only known once the batch pops)."""
    if not _tracing_here():
        return
    ctx = parent if parent is not None else current()
    if ctx is None:
        trace_id, parent_id = new_trace_id(), None
    else:
        trace_id, parent_id = ctx
    _store({"trace": trace_id, "span": _new_span_id(),
            "parent": parent_id, "name": name, "t0_ns": int(t0_ns),
            "dur_ns": int(dur_ns),
            "thread": threading.current_thread().name, "attrs": attrs})


def _store(rec):
    with _RING_LOCK:
        _RING.append(rec)
    _STATS["obs_spans"] += 1
    col = getattr(_TLS, "collect", None)
    if col is not None:
        col.append(rec)


@contextlib.contextmanager
def context(ctx, force=False):
    """Re-enter a captured context on this thread (cross-thread
    propagation). ``force=True`` additionally turns tracing on for the
    duration — a process replica serving a traced request must record
    spans even though its own ``MXNET_TPU_TORCH_OBS_TRACE`` may be unset."""
    prev = getattr(_TLS, "ctx", None)
    prev_force = getattr(_TLS, "force", False)
    _TLS.ctx = ctx
    if force:
        _TLS.force = True
    try:
        yield
    finally:
        _TLS.ctx = prev
        _TLS.force = prev_force


@contextlib.contextmanager
def collect():
    """Collect every span record ended on this thread while the block
    runs (nested consumers stack). The fleet's process-replica worker
    wraps each request in this and ships the collected records back with
    the reply; the parent feeds them to :func:`ingest`."""
    prev = getattr(_TLS, "collect", None)
    col = []
    _TLS.collect = col
    try:
        yield col
    finally:
        _TLS.collect = prev
        if prev is not None:
            prev.extend(col)


def ingest(records):
    """Merge span records produced in another process (shipped over the
    replica pipe) into the local ring so ``spans()`` shows one connected
    tree per trace id."""
    n = 0
    with _RING_LOCK:
        for rec in records or ():
            if isinstance(rec, dict) and "span" in rec and "name" in rec:
                _RING.append(rec)
                n += 1
    _STATS["obs_spans_shipped"] += n
    return n


def spans(trace_id=None, name=None):
    """Snapshot of the ended-span ring (insertion order), optionally
    filtered by trace id and/or span name."""
    with _RING_LOCK:
        out = list(_RING)
    if trace_id is not None:
        out = [s for s in out if s["trace"] == trace_id]
    if name is not None:
        out = [s for s in out if s["name"] == name]
    return out


def roots(names=()):
    """Root-span records (``parent is None``) currently in the ring,
    optionally restricted to a set of span names — the entry points
    incident exemplars and timeline exports start from."""
    names = set(names)
    return [s for s in spans()
            if s["parent"] is None and (not names or s["name"] in names)]


def clear():
    with _RING_LOCK:
        _RING.clear()

"""Self-healing serving fleet: supervised replicas behind a fault-isolating
router (port of ``mxnet_tpu/serving/fleet.py``).

- Replicas each own a Predictor behind a BatchServer. Thread replicas
  (default) share the process, and on the card the device: each captures
  its own bucket graphs (one capture at a time, under the capture lock,
  while its siblings replay). Process replicas (``mode='process'``) build
  their Predictor in a spawned child that initializes CUDA itself and
  builds any missing kernel under ``ops/_build.py``'s file lock; batches
  and outputs cross the pipe as host numpy arrays, never by CUDA IPC, and
  an injected ``replica_crash`` is a real ``os._exit``. The factory of a
  process fleet must be picklable (a module-level function).
- :class:`ReplicaSupervisor` health-probes every HEALTHY replica on a
  cadence (the watchdog's ``probe`` / ``batch`` deadline bounds a probe)
  and walks a failed one through
  ``HEALTHY -> DRAINING -> DEAD -> RESTARTING -> WARMING -> HEALTHY``:
  drain under the batch deadline, rebuild from the factory, re-admit
  through a half-open breaker probe. The port has no AOT cache (ROADMAP
  Queue 1 item 4): a restarted replica captures its bucket graphs again.
  A replica abandoned in a hang keeps its Predictor (and its graphs and
  their memory pool) referenced from its wedged worker thread until the
  thread returns, so no graph is freed while it could still replay.
- :class:`Router` balances by outstanding work, retries a failed attempt
  on a DIFFERENT replica after capped jittered backoff with the remaining
  deadline budget (an expired request is never retried), hedges tail
  requests (``MXNET_TPU_TORCH_FLEET_HEDGE_MS``), circuit-breaks a replica
  after K consecutive failures, and sheds with a structured
  :class:`FleetOverloaded` when no replica is eligible.
- :class:`StreamRouter` fronts N DecodeBatchers: a decode engine that
  dies mid-stream hands its streams to a live sibling, which prefills
  the prompt plus the tokens already streamed and continues.

Invariant: every request the router admits terminates, with a result or
a structured error, even while replicas are killed mid-batch.

Settings default from ``MXNET_TPU_TORCH_FLEET_REPLICAS`` (2), ``_MODE``
(thread), ``_RETRIES`` (2), ``_BACKOFF_MS`` (10), ``_BACKOFF_CAP_MS``
(1000), ``_HEDGE_MS`` (off), ``_BREAKER_K`` (3),
``_BREAKER_COOLDOWN_MS`` (1000), ``_PROBE_INTERVAL_MS`` (200),
``_MP_START`` (spawn) and ``_SPAWN_TIMEOUT`` (120 s).
"""
from __future__ import annotations

import heapq
import itertools
import os
import random as _random
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future

from ..base import MXNetError
from ..observability import flight as _obs_flight
from ..observability import trace as _obs_trace
from ..resilience import faults as _faults
from ..resilience import watchdog as _watchdog
from ..resilience.sentinel import HealthSentinel, NumericHealthError
from . import _STATS, _percentile_us, _register_fleet
from .batcher import (BatchServer, DeadlineExceeded, ServerClosed,
                      ServerOverloaded, _env_float, _env_int, _try_resolve)


def _to_host(t):
    """A tensor (or array) -> (numpy array, torch dtype name) for the
    pipe; bfloat16, which numpy lacks, travels as its int16 bits."""
    import numpy as np
    import torch

    if not isinstance(t, torch.Tensor):
        a = np.asarray(t)
        return a, None
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().copy(), "bfloat16"
    return t.numpy().copy(), None


def _from_host(item):
    import torch

    a, dtype = item
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _payload(data):
    if isinstance(data, dict):
        return {k: _to_host(v) for k, v in data.items()}
    return _to_host(data)


def _unpayload(p):
    if isinstance(p, dict):
        return {k: _from_host(v) for k, v in p.items()}
    return _from_host(p)

__all__ = ["Fleet", "FleetClosed", "FleetOverloaded", "ReplicaSupervisor",
           "Router", "STATES", "StreamRouter"]

STATES = ("HEALTHY", "DRAINING", "DEAD", "RESTARTING", "WARMING")

_jitter = _random.Random()

_THREAD = "mxnet-torch-fleet"


class FleetOverloaded(RuntimeError):
    """No replica can take the request: every member of the model's
    replica set is out of rotation (draining/restarting) or has its
    circuit breaker open. Structured so clients can back off:
    ``model``, ``total``, ``open_breakers``, ``unhealthy``,
    ``retry_after_ms`` (earliest breaker cooldown expiry, or None)."""

    def __init__(self, model, total, open_breakers, unhealthy,
                 retry_after_ms=None):
        self.model = model
        self.total = total
        self.open_breakers = open_breakers
        self.unhealthy = unhealthy
        self.retry_after_ms = retry_after_ms
        after = ("" if retry_after_ms is None
                 else f"; retry after ~{retry_after_ms:.0f}ms")
        super().__init__(
            f"fleet overloaded for model {model!r}: {unhealthy} of {total} "
            f"replica(s) out of rotation, {open_breakers} breaker(s) open"
            + after)


class FleetClosed(RuntimeError):
    """The fleet was closed; outstanding requests are failed with this
    (structured, never silently dropped)."""


def _failed_future(exc):
    fut = Future()
    fut.set_exception(exc)
    return fut


def _variant_key(model, variant):
    """Replica-group name of one dtype variant (``model@variant``) —
    the shared addressing between Fleet construction and routing."""
    return f"{model}@{variant}" if variant is not None else model


def _backoff_delay(base_s, cap_s, attempt, rng=None):
    """Capped jittered exponential backoff: uniform over the upper half
    of the exponential ceiling ``base * 2^(attempt-1)``, so retries of
    many requests do not arrive together."""
    rng = _jitter if rng is None else rng
    ceiling = min(float(base_s) * (2 ** max(0, int(attempt) - 1)),
                  float(cap_s))
    return rng.uniform(ceiling / 2.0, ceiling)


def _probe_deadline_default():
    """Probe deadline: the watchdog ``probe`` phase deadline when set,
    else the ``batch`` phase deadline (a probe is one tiny batch), else
    5 s — a probe may never block the supervisor forever."""
    for phase in ("probe", "batch"):
        t = _watchdog.timeout_for(phase)
        if t is not None:
            return t
    return 5.0


# --------------------------------------------------------------------- breaker

class _Breaker:
    """Per-replica circuit breaker: K consecutive failures open it; after
    ``cooldown_s`` one half-open trial is allowed — success closes it,
    failure re-opens. The supervisor's post-restart warm probe goes
    through :meth:`begin_probe` so re-admission is always a half-open
    trial (counted in ``fleet_half_open_probes``)."""

    def __init__(self, k, cooldown_s):
        self._lock = threading.Lock()
        self.k = max(1, int(k))
        self.cooldown_s = float(cooldown_s)
        self.state = "closed"        # closed | open | half_open
        self.consecutive = 0
        self.open_until = 0.0
        self.trial_inflight = False

    def can_try(self, now):
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                return now >= self.open_until
            return not self.trial_inflight

    def begin_trial(self, now):
        """Consume the half-open trial slot (no-op while closed).
        Returns True when the caller's attempt IS the trial."""
        with self._lock:
            if self.state == "closed":
                return False
            if self.state == "open" and now >= self.open_until:
                self.state = "half_open"
            if self.state == "half_open" and not self.trial_inflight:
                self.trial_inflight = True
                _STATS["fleet_half_open_probes"] += 1
                return True
            return False

    def begin_probe(self):
        """Force half-open for the supervisor's re-admission probe."""
        with self._lock:
            self.state = "half_open"
            self.trial_inflight = True
            _STATS["fleet_half_open_probes"] += 1

    def note_success(self):
        with self._lock:
            self.state = "closed"
            self.consecutive = 0
            self.trial_inflight = False

    def note_failure(self):
        """Record one failure; returns True when this call OPENED the
        breaker (caller escalates to the supervisor)."""
        with self._lock:
            self.consecutive += 1
            trip = (self.state == "half_open"
                    or (self.state == "closed" and self.consecutive >= self.k))
            if not trip:
                return False
            opened = self.state != "open"
            self.state = "open"
            self.trial_inflight = False
            self.open_until = time.monotonic() + self.cooldown_s
            if opened:
                _STATS["fleet_breaker_opens"] += 1
            return opened

    @property
    def is_open(self):
        with self._lock:
            return self.state == "open"


# -------------------------------------------------------------------- replicas

class _ReplicaFaultProxy:
    """Wraps a replica's Predictor so the replica-addressed fault hooks
    (``replica_crash`` / ``replica_hang`` / ``replica_nan_storm``) fire
    inside the real serving path — through the BatchServer's watchdog
    guard and the sentinel's output check, not short-circuited."""

    def __init__(self, inner, rid):
        self._inner = inner
        self._rid = rid

    def predict_raw(self, feeds):
        _faults.maybe_replica_crash(self._rid)
        _faults.maybe_replica_hang(self._rid)
        feeds = _faults.maybe_replica_nan_storm(self._rid, feeds)
        # sdc_serving corrupts the OUTPUT silently (no crash, no NaN
        # storm): only the integrity golden-query audit can catch it
        return _faults.maybe_sdc_serving(
            self._rid, self._inner.predict_raw(feeds))

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _ThreadReplica:
    """One in-process replica: its own Predictor + BatchServer. Shares
    the interpreter (a hard crash of the worker thread is contained by
    the batcher's dead-worker cleanup); use process mode for true
    isolation."""

    mode = "thread"

    def __init__(self, model, rid, factory, server_kw, breaker):
        self.model = model
        self.rid = rid
        self.breaker = breaker
        self._factory = factory
        self._server_kw = dict(server_kw or {})
        self._lock = threading.Lock()     # guards server/predictor swap
        self.state = "RESTARTING"
        self.scale_drain = False          # draining for SCALE, not health
        self.outstanding = 0              # mutated under the Router lock
        self.generation = 0
        self.transitions = deque(maxlen=64)
        self._lat = deque(maxlen=2048)    # seconds, router submit -> result
        self._lat_lock = threading.Lock()
        self.predictor = None
        self.server = None

    def build(self):
        """(Re)build the replica: a fresh Predictor from the factory (its
        bucket graphs captured again: the port has no AOT cache) behind a
        fresh BatchServer."""
        pred = self._factory()
        server = BatchServer(_ReplicaFaultProxy(pred, self.rid),
                             **self._server_kw)
        with self._lock:
            self.predictor = pred
            self.server = server
            self.generation += 1

    def submit(self, data, deadline_ms=None):
        with self._lock:
            server = self.server
        if server is None:
            raise ServerClosed(
                f"replica {self.model}/{self.rid} has no live server")
        return server.submit(data, deadline_ms=deadline_ms)

    def _probe_feeds(self):
        pred = self.predictor
        if pred is None or not hasattr(pred, "_probe_feeds"):
            return None
        return pred._probe_feeds()

    def probe_start(self, timeout):
        """Begin one health probe without blocking: a 1-row zero batch
        through the full serving path (predictors without declared input
        shapes fall back to a worker-liveness check). Returns a Future,
        or None for an immediately-failed probe — so the supervisor can
        launch every replica's probe first and wait on them TOGETHER
        (one wedged replica must not delay detection of the others)."""
        with self._lock:
            server = self.server
        if server is None:
            return None
        feeds = self._probe_feeds()
        if feeds is None:
            fut = Future()
            if server._worker.is_alive():
                fut.set_result(True)
            else:
                fut.set_exception(ServerClosed(
                    f"replica {self.model}/{self.rid} worker is dead"))
            return fut
        try:
            return server.submit(feeds, deadline_ms=timeout * 1e3)
        except Exception:
            return None

    def probe(self, timeout):
        """One blocking health probe; False on any failure or timeout."""
        fut = self.probe_start(timeout)
        if fut is None:
            return False
        try:
            fut.result(timeout=timeout)
            return True
        except Exception:
            return False

    def drain_close(self, timeout=None):
        """Take the server out of service, letting in-flight batches
        finish under the (bounded) drain deadline; leftover futures are
        failed by the server, never leaked."""
        with self._lock:
            server, self.server = self.server, None
            self.predictor = None
        if server is not None:
            server.close(drain=True, timeout=timeout)

    def alive(self):
        with self._lock:
            server = self.server
        return server is not None and server._worker.is_alive()

    @property
    def display_state(self):
        """``state`` with scale-driven drains distinguished: a replica
        draining because the autoscaler removed it (not because it is
        sick) reports ``DRAINING(scale)`` — and is excluded from
        health-floor accounting (observability.alerts/metrics), so a
        scale-down on a healthy fleet can never read as degradation."""
        if self.scale_drain and self.state == "DRAINING":
            return "DRAINING(scale)"
        return self.state

    def record_latency(self, seconds):
        with self._lat_lock:
            self._lat.append(seconds)

    def latency_snapshot(self):
        with self._lat_lock:
            return sorted(self._lat)

    def reset_latencies(self):
        with self._lat_lock:
            self._lat.clear()

    def __repr__(self):
        return (f"<{type(self).__name__} {self.model}/{self.rid} "
                f"{self.state} gen={self.generation}>")


def _safe_exc(e):
    """An exception the pipe can pickle (fall back to a stringified
    RuntimeError so a weird error class can never wedge the reply)."""
    import pickle

    try:
        pickle.dumps(e)
        return e
    except Exception:
        return RuntimeError(f"{type(e).__name__}: {e}")


def _mp_worker(conn, factory, rid):
    """Process replica worker: build the Predictor, then serve
    (req_id, batch[, trace_ctx]) messages one at a time until a None
    shutdown message or pipe EOF. ``replica_crash`` is a real process exit.
    Faults reach a spawned child through ``MXNET_TPU_TORCH_FAULTS`` in its
    environment (``inject()`` in the parent arms the parent only).

    Every batch's outputs pass the same HealthSentinel check the
    in-process BatchServer applies, and go back as host numpy arrays. A
    ``__ping__`` runs a real 1-row zero batch when the predictor has
    probe feeds."""
    try:
        pred = _ReplicaFaultProxy(factory(), rid)
    except BaseException as e:  # noqa: BLE001 - report, then die
        try:
            conn.send(("__fatal__", _safe_exc(e)))
        except Exception:
            pass
        os._exit(17)
    sentinel = HealthSentinel(
        policy=os.environ.get("MXNET_TPU_TORCH_SERVING_HEALTH",
                              "skip_batch"))
    probe_feeds = pred._probe_feeds() if hasattr(pred, "_probe_feeds") \
        else None
    qtag = getattr(pred, "quant_tag", "")

    def run(feeds):
        outs, _n = pred.predict_raw(feeds)
        healthy, err = True, None
        try:
            healthy = sentinel.check_finite(
                outs, what=f"replica {rid} batch outputs{qtag}")
        except NumericHealthError as e:
            healthy, err = False, e
        if not healthy:
            raise err or NumericHealthError(
                sentinel.last_reason
                or f"non-finite values in replica {rid} batch outputs")
        return [_to_host(o) for o in outs]

    try:
        conn.send(("__ready__", os.getpid()))
    except Exception:
        os._exit(19)
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            os._exit(0)
        if msg is None:
            os._exit(0)
        req_id, data = msg[0], msg[1]
        ctx = msg[2] if len(msg) > 2 else None
        if isinstance(data, str) and data == "__ping__":
            try:
                if probe_feeds is not None:
                    run(probe_feeds)   # the probe runs real model math
                reply = "__pong__"
            except _faults.ReplicaCrash:
                os._exit(23)
            except BaseException as e:  # noqa: BLE001
                reply = _safe_exc(e)
            try:
                conn.send((req_id, reply, None))
            except Exception:
                os._exit(19)
            continue
        col = None
        try:
            feeds = _unpayload(data)
            if ctx is not None:
                # a shipped context authorizes tracing this request
                with _obs_trace.context(ctx, force=True), \
                        _obs_trace.collect() as col:
                    with _obs_trace.span("serve.replica", replica=rid):
                        reply = run(feeds)
            else:
                reply = run(feeds)
        except _faults.ReplicaCrash:
            os._exit(23)
        except BaseException as e:  # noqa: BLE001 - must answer or die
            reply = _safe_exc(e)
        try:
            conn.send((req_id, reply, col))
        except Exception:
            os._exit(19)


class _ProcessReplica(_ThreadReplica):
    """Subprocess replica: the Predictor lives in a child process (one
    request at a time over a pipe), so a crash is a real process death,
    detected by the reader thread or the supervisor's probe and survived
    by a restart. Start method: ``MXNET_TPU_TORCH_FLEET_MP_START``
    (default ``spawn``: a forked child cannot use the parent's CUDA
    context). ``pid`` is the live child's process id."""

    mode = "process"

    def __init__(self, model, rid, factory, server_kw, breaker):
        super().__init__(model, rid, factory, server_kw, breaker)
        self._proc = None
        self._conn = None
        self._reader = None
        self._writer = None
        self._plock = threading.Lock()
        self._pending = {}            # req_id -> Future
        self._req_ids = itertools.count(1)
        # All pipe sends go through ONE writer thread fed by a bounded
        # queue: a wedged child that stops recv()ing fills the OS pipe
        # buffer, and a blocking conn.send from a caller (or worse, the
        # router's single scheduler thread) would wedge the whole fleet.
        # Overflow sheds with ServerOverloaded (back-pressure, retried
        # elsewhere, never charged to the breaker).
        self._send_cond = threading.Condition()
        self._sendq = deque()
        self._send_closed = True
        self._sendq_depth = _env_int("MXNET_TPU_TORCH_SERVING_QUEUE_DEPTH",
                                     256)
        self.pid = None

    def build(self):
        import multiprocessing as mp

        ctx = mp.get_context(
            os.environ.get("MXNET_TPU_TORCH_FLEET_MP_START", "spawn").strip()
            or "spawn")
        parent, child = ctx.Pipe(duplex=True)
        proc = ctx.Process(target=_mp_worker,
                           args=(child, self._factory, self.rid),
                           name=f"{_THREAD}-{self.model}-{self.rid}",
                           daemon=True)
        proc.start()
        child.close()
        # ready handshake BEFORE the replica goes into service: a child
        # whose factory failed (or whose spawn died importing the
        # framework) must fail build() here — the supervisor's restart
        # backoff owns the retry, not a probe discovering it later
        spawn_timeout = _env_float("MXNET_TPU_TORCH_FLEET_SPAWN_TIMEOUT",
                                   120.0)
        try:
            if not parent.poll(spawn_timeout):
                raise ServerClosed(
                    f"replica {self.model}/{self.rid} worker process sent "
                    f"no ready handshake within {spawn_timeout:.3g}s")
            tag, payload = parent.recv()
        except ServerClosed:
            proc.terminate()
            proc.join(1.0)
            raise
        except (EOFError, OSError) as e:
            proc.join(1.0)
            raise ServerClosed(
                f"replica {self.model}/{self.rid} worker process died "
                f"before its ready handshake: {e}") from None
        if tag == "__fatal__":
            proc.join(1.0)
            raise payload if isinstance(payload, BaseException) else \
                ServerClosed(str(payload))
        if tag != "__ready__":
            proc.terminate()
            proc.join(1.0)
            raise ServerClosed(
                f"replica {self.model}/{self.rid} worker process sent "
                f"unexpected handshake {tag!r}")
        with self._lock:
            self._proc = proc
            self._conn = parent
            self.pid = payload
            self.generation += 1
        reader = threading.Thread(
            target=self._read_loop, args=(parent,),
            name=f"{_THREAD}-reader-{self.model}-{self.rid}",
            daemon=True)
        writer = threading.Thread(
            target=self._write_loop, args=(parent,),
            name=f"{_THREAD}-writer-{self.model}-{self.rid}",
            daemon=True)
        with self._lock:
            self._reader = reader
            self._writer = writer
        with self._send_cond:
            self._sendq.clear()
            self._send_closed = False
        reader.start()
        writer.start()

    def _read_loop(self, conn):
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break
            req_id, payload = msg[0], msg[1]
            if req_id == "__fatal__":
                break
            if len(msg) > 2 and msg[2]:
                # span records traced in the child: merge them into the
                # local ring so the request's tree is connected
                _obs_trace.ingest(msg[2])
            with self._plock:
                fut = self._pending.pop(req_id, None)
            if fut is None:
                continue
            if isinstance(payload, BaseException):
                if isinstance(payload, NumericHealthError):
                    # the child's sentinel rejected the batch; count it
                    # in the parent where the counters live
                    _STATS["serving_poisoned_batches"] += 1
                _try_resolve(fut, exc=payload)
            else:
                _try_resolve(fut, result=payload if req_id[0] == "p"
                             else [_from_host(o) for o in payload])
        # the pipe is gone: the process died (or is shutting down) —
        # every pending future must still terminate
        with self._plock:
            pending = list(self._pending.values())
            self._pending.clear()
        err = ServerClosed(
            f"replica {self.model}/{self.rid} worker process died")
        for fut in pending:
            _try_resolve(fut, exc=err)

    def _write_loop(self, conn):
        """Sole pipe sender. Blocks only this daemon thread when the OS
        pipe buffer is full; drain_close unwedges it by terminating the
        child (EPIPE) and the ``None`` sentinel shuts it down after the
        queued requests flushed — that ordering IS the drain."""
        while True:
            with self._send_cond:
                while not self._sendq:
                    self._send_cond.wait()
                item = self._sendq.popleft()
            if item is None:
                try:
                    conn.send(None)
                except Exception:
                    pass
                return
            req_id, payload, ctx = item
            try:
                conn.send((req_id, payload, ctx))
            except Exception as e:
                with self._plock:
                    fut = self._pending.pop(req_id, None)
                if fut is not None:
                    _try_resolve(fut, exc=ServerClosed(
                        f"pipe send to replica {self.model}/{self.rid} "
                        f"failed: {e}"))

    def _send(self, req_id, payload, ctx=None):
        fut = Future()
        with self._plock:
            self._pending[req_id] = fut
        err = None
        with self._send_cond:
            if self._send_closed:
                err = ServerClosed(
                    f"replica {self.model}/{self.rid} has no live "
                    "worker process")
            elif len(self._sendq) >= self._sendq_depth:
                err = ServerOverloaded(
                    f"replica {self.model}/{self.rid} send queue at its "
                    f"high-water mark {self._sendq_depth}")
            else:
                self._sendq.append((req_id, payload, ctx))
                self._send_cond.notify_all()
        if err is not None:
            with self._plock:
                self._pending.pop(req_id, None)
            _try_resolve(fut, exc=err)
        return fut

    def submit(self, data, deadline_ms=None):
        if deadline_ms is not None and deadline_ms <= 0:
            return _failed_future(DeadlineExceeded(
                f"deadline budget ({deadline_ms:.3g}ms) already spent "
                "at admission"))
        return self._send(f"r{next(self._req_ids)}", _payload(data),
                          ctx=_obs_trace.current())

    def probe_start(self, timeout):
        if not self.alive():
            return None
        return self._send(f"p{next(self._req_ids)}", "__ping__")

    def drain_close(self, timeout=None):
        t = timeout if timeout is not None else 5.0
        with self._lock:
            proc, self._proc = self._proc, None
            conn = self._conn
            reader = self._reader
            writer, self._writer = self._writer, None
        with self._send_cond:
            self._send_closed = True
            if writer is not None:
                # the sentinel rides BEHIND the queued requests: the
                # writer flushes them, the child answers them, then exits
                self._sendq.append(None)
                self._send_cond.notify_all()
        if writer is not None:
            writer.join(t)
        if proc is not None:
            proc.join(t)
            if proc.is_alive():
                proc.terminate()      # also unwedges a blocked send (EPIPE)
                proc.join(1.0)
        if writer is not None and writer.is_alive():
            writer.join(1.0)
        # anything still queued never reached the pipe: fail it now
        with self._send_cond:
            stale = [i for i in self._sendq if i is not None]
            self._sendq.clear()
        for req_id, _payload, _ctx in stale:
            with self._plock:
                fut = self._pending.pop(req_id, None)
            if fut is not None:
                _try_resolve(fut, exc=ServerClosed(
                    f"replica {self.model}/{self.rid} closed before the "
                    "request reached its worker process"))
        with self._lock:
            self._conn = None
            self.pid = None
        if conn is not None:
            try:
                conn.close()          # unblocks the reader -> fails pending
            except Exception:
                pass
        if reader is not None:
            reader.join(2.0)

    def alive(self):
        with self._lock:
            proc = self._proc
        return proc is not None and proc.is_alive()


class _Group:
    """One model's replica set."""

    def __init__(self, model, replicas):
        self.model = model
        self.replicas = list(replicas)


# ------------------------------------------------------------------ supervisor

class ReplicaSupervisor:
    """Owns the replica sets: builds them, health-probes HEALTHY members
    on a cadence, and runs the drain -> restart -> warm -> re-admit
    state machine when a replica fails (probe failure, breaker open, or
    an operator's :meth:`fail_replica`).

    With ``kvstore`` attached, fleet membership rides the watchdog's
    peer bookkeeping: a draining replica's rid is marked dead and
    re-admission clears exactly that rank through
    ``kvstore.excise_dead_peers(ranks=[rid])``.
    """

    def __init__(self, groups, *, kvstore=None, probe_interval_s=0.2,
                 probe_timeout_s=None, drain_timeout_s=None,
                 probe_strikes=2, restart_backoff_s=0.05,
                 restart_backoff_cap_s=2.0):
        self._groups = dict(groups)
        self._kv = kvstore
        self._probe_interval_s = float(probe_interval_s)
        self._probe_timeout_s = probe_timeout_s
        self._drain_timeout_s = drain_timeout_s
        self._probe_strikes = max(1, int(probe_strikes))
        self._restart_backoff_s = float(restart_backoff_s)
        self._restart_backoff_cap_s = float(restart_backoff_cap_s)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._workers = []            # live restart threads (joined at close)
        self._strikes = {}            # rid -> consecutive probe failures
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name=f"{_THREAD}-probe",
            daemon=True)

    # ------------------------------------------------------------------ config
    def _probe_timeout(self):
        if self._probe_timeout_s is not None:
            return self._probe_timeout_s
        return _probe_deadline_default()

    def _drain_timeout(self):
        if self._drain_timeout_s is not None:
            return self._drain_timeout_s
        per_batch = _watchdog.timeout_for("batch")
        return per_batch * 2 + 1.0 if per_batch is not None else 5.0

    # ------------------------------------------------------------------ lookup
    def group(self, model):
        try:
            return self._groups[model]
        except KeyError:
            raise MXNetError(
                f"fleet serves models {sorted(self._groups)}, "
                f"not {model!r}") from None

    def models(self):
        return sorted(self._groups)

    def replicas(self, model="default"):
        return list(self.group(model).replicas)

    # ------------------------------------------------------------------- start
    def start(self):
        """Build every replica (serially: one capture at a time) and
        start probing. A factory failure tears the already-built members
        back down before re-raising: no orphaned threads or processes."""
        built = []
        try:
            for group in self._groups.values():
                for replica in group.replicas:
                    replica.build()
                    built.append(replica)
                    self._set(replica, "HEALTHY", "initial build")
        except BaseException:
            self._stop.set()
            for replica in built:
                try:
                    replica.drain_close(timeout=self._drain_timeout())
                except Exception:
                    pass
            raise
        self._probe_thread.start()
        return self

    def _set(self, replica, state, reason):
        with self._lock:
            prev = replica.state
            replica.state = state
            replica.transitions.append(
                (time.monotonic(), prev, state, reason))
        _obs_flight.record("fleet", model=replica.model,
                           replica=replica.rid, prev=prev, state=state,
                           reason=reason)

    # ------------------------------------------------------------------ probing
    def _probe_loop(self):
        while not self._stop.wait(self._probe_interval_s):
            timeout = self._probe_timeout()
            # launch EVERY healthy replica's probe first, then wait on
            # them against one shared deadline: a single wedged replica
            # costs one probe_timeout per pass, not one per sibling
            started = []
            for group in list(self._groups.values()):
                for replica in list(group.replicas):
                    if replica.state != "HEALTHY":
                        continue
                    started.append((replica, replica.probe_start(timeout)))
            deadline = time.monotonic() + timeout
            for replica, fut in started:
                if self._stop.is_set():
                    return
                ok = False
                if fut is not None:
                    try:
                        fut.result(timeout=max(0.0,
                                               deadline - time.monotonic()))
                        ok = True
                    except Exception:
                        ok = False
                if ok and replica.alive():
                    self._strikes[replica.rid] = 0
                    continue
                _STATS["fleet_probe_failures"] += 1
                strikes = self._strikes.get(replica.rid, 0) + 1
                self._strikes[replica.rid] = strikes
                # a dead worker is definitive; a timed-out probe needs
                # `probe_strikes` consecutive misses (one slow probe
                # under load must not kill a healthy replica)
                if not replica.alive() or strikes >= self._probe_strikes:
                    self._strikes[replica.rid] = 0
                    self.fail_replica(replica, reason="probe_failure")

    # ------------------------------------------------------------------ scaling
    def add_replica(self, model, replica):
        """Scale-up admission: build the replica (every declared bucket
        captured), then pass one half-open breaker probe through the full
        serving path BEFORE the router can see it. Joins the group only on
        a passing probe; a build or probe failure tears the newcomer down
        and raises, the existing members untouched."""
        group = self.group(model)
        self._set(replica, "RESTARTING", "scale_up")
        try:
            replica.build()
        except Exception as e:
            self._set(replica, "DEAD", f"scale_up build failed: {e}")
            raise
        self._set(replica, "WARMING", "scale_up")
        # every declared bucket is captured BEFORE the router can see
        # this replica: no first request pays a capture
        pred = getattr(replica, "predictor", None)
        if pred is not None and getattr(pred, "_input_tails", None):
            try:
                pred.warmup()
            except Exception as e:
                replica.drain_close(timeout=self._drain_timeout())
                self._set(replica, "DEAD", f"scale_up warmup failed: {e}")
                raise MXNetError(
                    f"scale-up replica {model}/{replica.rid} failed its "
                    f"pre-admission bucket warmup: {e}")
        replica.breaker.begin_probe()
        if not replica.probe(self._probe_timeout()):
            replica.drain_close(timeout=self._drain_timeout())
            self._set(replica, "DEAD", "scale_up (warm probe failed)")
            raise MXNetError(
                f"scale-up replica {model}/{replica.rid} failed its "
                "admission probe; not admitted")
        replica.breaker.note_success()
        with self._lock:
            group.replicas.append(replica)
        self._set(replica, "HEALTHY", "scale_up")
        _STATS["fleet_scale_up"] += 1
        return replica

    def remove_replica(self, model, replica=None):
        """Scale-down: drain one HEALTHY replica for *scale* (not
        health) and remove it from the group. In-flight requests finish
        under the drain deadline; while draining the replica reports
        ``DRAINING(scale)`` and never counts against the health floor.
        Picks the least-loaded member when ``replica`` is None. Returns
        the removed replica, or None when nothing was eligible."""
        group = self.group(model)
        with self._lock:
            if self._stop.is_set():
                return None
            cands = [r for r in group.replicas if r.state == "HEALTHY"]
            if replica is not None:
                cands = [r for r in cands if r is replica]
            if not cands or len([r for r in group.replicas
                                 if not r.scale_drain]) <= 1:
                return None           # never drain the last member
            victim = min(cands, key=lambda r: (r.outstanding, -r.rid))
            prev = victim.state
            victim.state = "DRAINING"
            victim.scale_drain = True
            victim.transitions.append(
                (time.monotonic(), prev, "DRAINING(scale)", "scale_down"))
            worker = threading.Thread(
                target=self._scale_drain, args=(group, victim),
                name=f"{_THREAD}-scaledown-{victim.model}-{victim.rid}",
                daemon=True)
            self._workers = [t for t in self._workers if t.is_alive()]
            self._workers.append(worker)
        _STATS["fleet_scale_down"] += 1
        _obs_flight.record("fleet", model=victim.model, replica=victim.rid,
                           prev=prev, state="DRAINING(scale)",
                           reason="scale_down")
        worker.start()
        return victim

    def _scale_drain(self, group, replica):
        replica.drain_close(timeout=self._drain_timeout())
        with self._lock:
            try:
                group.replicas.remove(replica)
            except ValueError:
                pass
            prev = replica.display_state
            replica.state = "DEAD"
            replica.transitions.append(
                (time.monotonic(), prev, "DEAD", "scale_down complete"))
        _obs_flight.record("fleet", model=replica.model,
                           replica=replica.rid, prev=prev, state="DEAD",
                           reason="scale_down complete")

    # ------------------------------------------------------- failure + restart
    def on_breaker_open(self, replica):
        """Router escalation: K consecutive request failures tripped the
        breaker — treat the replica as sick and recycle it."""
        self.fail_replica(replica, reason="breaker_open")

    def fail_replica(self, replica, reason="operator"):
        """Take a replica out of rotation and recycle it:
        DRAINING (in-flight batches finish under the batch deadline) ->
        DEAD -> RESTARTING (factory rebuild, graphs captured again) ->
        WARMING (half-open breaker probe) -> HEALTHY. Idempotent: a
        replica already anywhere on its way through the machine is left
        alone — DRAINING..WARMING is owned by ITS restart thread, and a
        second concurrent restart would fight over the server swap.
        Returns True when this call initiated the transition."""
        with self._lock:
            if self._stop.is_set() or replica.state != "HEALTHY":
                return False
            prev = replica.state
            replica.state = "DRAINING"
            replica.transitions.append(
                (time.monotonic(), prev, "DRAINING", reason))
            worker = threading.Thread(
                target=self._restart, args=(replica, reason),
                name=f"{_THREAD}-restart-{replica.model}-{replica.rid}",
                daemon=True)
            self._workers = [t for t in self._workers if t.is_alive()]
            self._workers.append(worker)
        _STATS["fleet_drains"] += 1
        _obs_flight.record("fleet", model=replica.model,
                           replica=replica.rid, prev="HEALTHY",
                           state="DRAINING", reason=reason)
        if self._kv is not None:
            _watchdog.mark_peer_dead(replica.rid)
        worker.start()
        return True

    def _restart(self, replica, reason):
        replica.drain_close(timeout=self._drain_timeout())
        self._set(replica, "DEAD", reason)
        attempt = 0
        while not self._stop.is_set():
            self._set(replica, "RESTARTING", reason)
            _STATS["fleet_restarts"] += 1
            try:
                replica.build()
            except Exception:
                attempt += 1
                self._stop.wait(_backoff_delay(
                    self._restart_backoff_s, self._restart_backoff_cap_s,
                    attempt))
                continue
            self._set(replica, "WARMING", reason)
            # re-admission is always a half-open breaker trial: one probe
            # through the full serving path must succeed before the
            # router sees the replica again
            replica.breaker.begin_probe()
            warm_fails = 0
            while not self._stop.is_set():
                if not replica.alive():
                    break              # rebuilt worker died: rebuild again
                if replica.probe(self._probe_timeout()):
                    replica.breaker.note_success()
                    self._set(replica, "HEALTHY", reason)
                    if self._kv is not None:
                        self._kv.excise_dead_peers(ranks=[replica.rid])
                    return
                _STATS["fleet_probe_failures"] += 1
                warm_fails += 1
                if warm_fails >= self._probe_strikes:
                    break  # persistent warm failure: rebuild, with backoff
                self._stop.wait(self._probe_interval_s)
            if self._stop.is_set():
                # the fleet closed while this server was being rebuilt —
                # possibly AFTER close() gave up joining this thread: the
                # fresh server must not outlive the fleet
                replica.drain_close(timeout=self._drain_timeout())
                return
            replica.drain_close(timeout=self._drain_timeout())
            self._set(replica, "DEAD", f"{reason} (warm probe failed)")
            attempt += 1
            self._stop.wait(_backoff_delay(
                self._restart_backoff_s, self._restart_backoff_cap_s,
                attempt))

    # ------------------------------------------------------------------- close
    def close(self, timeout=10.0):
        self._stop.set()
        deadline = time.monotonic() + timeout
        if self._probe_thread.is_alive():
            self._probe_thread.join(max(0.1, deadline - time.monotonic()))
        with self._lock:
            workers = list(self._workers)
            self._workers = []
        for t in workers:
            t.join(max(0.1, deadline - time.monotonic()))
        for group in self._groups.values():
            for replica in group.replicas:
                self._set(replica, "DEAD", "fleet closed")
                replica.drain_close(timeout=self._drain_timeout())


# ---------------------------------------------------------------------- router

class _Scheduler:
    """One daemon timer thread running deferred router actions (retries
    after backoff, hedges, deadline expiries). Actions are plain
    callables; a raising action is swallowed — the scheduler must
    survive anything, like the watchdog monitor."""

    def __init__(self, name=f"{_THREAD}-timer"):
        self._heap = []
        self._cond = threading.Condition()
        self._seq = itertools.count()
        self._closed = False
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def call_later(self, delay_s, fn):
        with self._cond:
            if self._closed:
                return False
            heapq.heappush(self._heap, (time.monotonic() + max(0.0, delay_s),
                                        next(self._seq), fn))
            self._cond.notify_all()
        return True

    def _run(self):
        while True:
            with self._cond:
                if self._closed:
                    return
                if not self._heap:
                    self._cond.wait(60.0)
                    continue
                when, _seq, fn = self._heap[0]
                now = time.monotonic()
                if when > now:
                    self._cond.wait(min(when - now, 60.0))
                    continue
                heapq.heappop(self._heap)
            try:
                fn()
            except Exception:
                pass

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(2.0)


class _Tracked:
    """Router-side bookkeeping for one admitted request."""

    __slots__ = ("future", "model", "data", "deadline", "t0", "retries_left",
                 "backoff_attempt", "resolved", "inflight", "tried", "span",
                 "__weakref__")

    def __init__(self, model, data, deadline, retries):
        self.future = Future()
        self.model = model
        self.data = data
        self.deadline = deadline      # absolute monotonic, or None
        self.t0 = time.monotonic()
        self.retries_left = retries
        self.backoff_attempt = 0
        self.resolved = False
        self.inflight = []            # [(replica, attempt future, is_hedge)]
        self.tried = set()            # rids that have seen this request
        self.span = None              # the serve.request root trace span


def _charges_breaker(exc):
    """Which attempt failures count toward the replica's breaker: real
    replica faults (crash, stall, NaN, dead server), NOT back-pressure
    (overload shed), deadline expiry, or caller errors."""
    return not isinstance(exc, (DeadlineExceeded, ServerOverloaded,
                                MXNetError, FleetClosed))


def _retryable(exc):
    """DeadlineExceeded means the budget is spent — never retried; a
    caller error (MXNetError) is deterministic — retrying cannot help."""
    return not isinstance(exc, (DeadlineExceeded, MXNetError))


class Router:
    """Per-model request front-end over a :class:`ReplicaSupervisor`.

    ``submit`` always returns a Future that terminates: load-balanced
    attempt, retries with capped jittered backoff on *different*
    replicas carrying the remaining deadline budget, optional hedging,
    per-replica circuit breaking, structured shedding.
    """

    def __init__(self, supervisor, *, retries=None, backoff_ms=None,
                 backoff_cap_ms=None, hedge_ms=None, scheduler=None):
        self._sup = supervisor
        self._retries = (retries if retries is not None
                         else _env_int("MXNET_TPU_TORCH_FLEET_RETRIES", 2))
        self._backoff_s = (backoff_ms if backoff_ms is not None
                           else _env_float("MXNET_TPU_TORCH_FLEET_BACKOFF_MS",
                                           10.0)) / 1e3
        self._backoff_cap_s = (
            backoff_cap_ms if backoff_cap_ms is not None
            else _env_float("MXNET_TPU_TORCH_FLEET_BACKOFF_CAP_MS",
                            1000.0)) / 1e3
        hedge = (hedge_ms if hedge_ms is not None
                 else _env_float("MXNET_TPU_TORCH_FLEET_HEDGE_MS", 0.0))
        self._hedge_s = hedge / 1e3 if hedge and hedge > 0 else None
        self._sched = scheduler or _Scheduler()
        self._owns_sched = scheduler is None
        self._lock = threading.Lock()
        self._closed = False
        self._outstanding = set()

    # ---------------------------------------------------------------- selection
    def _pick(self, group, exclude=()):
        now = time.monotonic()
        with self._lock:
            cands = [r for r in group.replicas
                     if r.state == "HEALTHY" and r.rid not in exclude
                     and r.breaker.can_try(now)]
            if not cands:
                return None
            chosen = min(cands, key=lambda r: (r.outstanding, r.rid))
        chosen.breaker.begin_trial(now)
        return chosen

    def _overloaded(self, group):
        now = time.monotonic()
        open_breakers = unhealthy = total = 0
        retry_after = None
        for r in group.replicas:
            if r.scale_drain:
                continue   # leaving by scale decision: not degradation
            total += 1
            if r.state != "HEALTHY":
                unhealthy += 1
            if r.breaker.is_open:
                open_breakers += 1
                wait = (r.breaker.open_until - now) * 1e3
                if wait > 0 and (retry_after is None or wait < retry_after):
                    retry_after = wait
        _STATS["fleet_shed_overloaded"] += 1
        return FleetOverloaded(group.model, total,
                               open_breakers, unhealthy, retry_after)

    # ------------------------------------------------------------------- submit
    def submit(self, data, deadline_ms=None, model="default",
               variant=None):
        """Admit one request; returns a Future that ALWAYS terminates in
        a result or a structured error. ``deadline_ms`` is the total
        budget across every attempt — each attempt (and each retry's
        backoff) sees only what remains of it. ``variant`` addresses one
        dtype variant of ``model`` (e.g. ``'int8'``)."""
        model = _variant_key(model, variant)
        group = self._sup.group(model)
        _STATS["fleet_requests"] += 1
        now = time.monotonic()
        if deadline_ms is not None and deadline_ms <= 0:
            _STATS["fleet_deadline_exceeded"] += 1
            return _failed_future(DeadlineExceeded(
                f"deadline budget ({deadline_ms:.3g}ms) already spent "
                "at admission"))
        deadline = None if deadline_ms is None else now + deadline_ms / 1e3
        t = _Tracked(model, data, deadline, self._retries)
        # the request's root trace span: every attempt, the replica's
        # batch, and (for process replicas) the child's spans parent
        # under it — one connected tree per request; ended by _resolve.
        # Created BEFORE t joins _outstanding: a close() racing this
        # submit must find the span it is about to end, never a None it
        # would skip (leaving the root span open forever)
        t.span = _obs_trace.start_span("serve.request", model=model)
        with self._lock:
            if self._closed:
                t.span.end(outcome="FleetClosed")
                return _failed_future(FleetClosed("fleet is closed"))
            self._outstanding.add(t)
        replica = self._pick(group)
        if replica is None:
            self._resolve(t, exc=self._overloaded(group))
            return t.future
        self._attempt(t, replica)
        if deadline is not None:
            self._later(deadline - now + 0.002, self._expire, t)
        if self._hedge_s is not None and len(group.replicas) > 1 and \
                (deadline is None or now + self._hedge_s < deadline):
            self._later(self._hedge_s, self._hedge, t)
        return t.future

    def _later(self, delay_s, action, t):
        """``action(t)`` after ``delay_s``, through a weak reference: an
        unresolved request stays alive in ``_outstanding``, and a resolved
        one (its result with it) must not be held until its deadline
        timer fires."""
        ref = weakref.ref(t)

        def fire():
            tracked = ref()
            if tracked is not None:
                action(tracked)

        self._sched.call_later(delay_s, fire)

    # ----------------------------------------------------------------- attempts
    def _attempt(self, t, replica, is_hedge=False):
        now = time.monotonic()
        if t.deadline is not None and now >= t.deadline:
            self._expire(t)
            return
        remaining_ms = (None if t.deadline is None
                        else (t.deadline - now) * 1e3)
        with self._lock:
            if t.resolved:
                return
            data = t.data  # snapshot under the lock: _resolve nulls it
            replica.outstanding += 1
            t.tried.add(replica.rid)
        asp = _obs_trace.start_span(
            "serve.attempt",
            parent=t.span.ctx if t.span is not None else None,
            model=t.model, replica=replica.rid, hedge=bool(is_hedge))
        try:
            # enter the attempt's context so the replica path (batcher
            # request, or the process-replica pipe) inherits it
            with _obs_trace.context(asp.ctx):
                fut = replica.submit(data, deadline_ms=remaining_ms)
        except Exception as e:
            asp.end(error=type(e).__name__)
            with self._lock:
                replica.outstanding -= 1
            self._attempt_failed(t, replica, e)
            return
        with self._lock:
            if t.resolved:
                entry = None
            else:
                entry = (replica, fut, is_hedge)
                t.inflight.append(entry)
        if entry is None:
            asp.end(outcome="cancelled")
            fut.cancel()
            with self._lock:
                replica.outstanding -= 1
            return
        fut.add_done_callback(
            lambda f, t=t, r=replica, h=is_hedge, sp=asp:
                self._on_done(t, r, f, h, sp))

    def _on_done(self, t, replica, fut, is_hedge, asp=None):
        if fut.cancelled():
            if asp is not None:
                asp.end(outcome="cancelled")
            with self._lock:
                replica.outstanding -= 1
                t.inflight = [e for e in t.inflight if e[1] is not fut]
            return
        exc = fut.exception()
        if asp is not None:
            asp.end(**({} if exc is None
                       else {"error": type(exc).__name__}))
        with self._lock:
            replica.outstanding -= 1
            t.inflight = [e for e in t.inflight if e[1] is not fut]
        if exc is None:
            losers = self._resolve(t, result=fut.result())
            if losers is None:
                return            # someone else already won
            replica.breaker.note_success()
            replica.record_latency(time.monotonic() - t.t0)
            if is_hedge:
                _STATS["fleet_hedge_wins"] += 1
            return
        self._attempt_failed(t, replica, exc)

    def _attempt_failed(self, t, replica, exc):
        if _charges_breaker(exc):
            _STATS["fleet_replica_failures"] += 1
            if replica.breaker.note_failure():
                self._sup.on_breaker_open(replica)
        with self._lock:
            if t.resolved:
                return
            if t.inflight:
                return            # a hedged twin is still running: let it race
        now = time.monotonic()
        remaining = None if t.deadline is None else t.deadline - now
        expired = remaining is not None and remaining <= 0
        if not expired and _retryable(exc) and t.retries_left > 0:
            with self._lock:
                if t.resolved:
                    return
                t.retries_left -= 1
                t.backoff_attempt += 1
                attempt = t.backoff_attempt
            delay = _backoff_delay(self._backoff_s, self._backoff_cap_s,
                                   attempt)
            if remaining is not None:
                delay = min(delay, max(0.0, remaining - 1e-3))
            _STATS["fleet_retries"] += 1
            self._sched.call_later(
                delay, lambda: self._retry(t, exclude_rid=replica.rid))
            return
        if expired and not isinstance(exc, DeadlineExceeded):
            self._expire(t)
            return
        self._resolve(t, exc=exc)

    def _retry(self, t, exclude_rid):
        with self._lock:
            if t.resolved:
                return
        if t.deadline is not None and time.monotonic() >= t.deadline:
            self._expire(t)
            return
        group = self._sup.group(t.model)
        # prefer a replica this request has NOT failed on; fall back to
        # re-trying the failed one only when it is the sole survivor
        replica = self._pick(group, exclude={exclude_rid})
        if replica is None:
            replica = self._pick(group)
        if replica is None:
            self._resolve(t, exc=self._overloaded(group))
            return
        self._attempt(t, replica)

    def _hedge(self, t):
        with self._lock:
            if t.resolved or not t.inflight:
                return            # failed attempts take the retry path
            busy = {e[0].rid for e in t.inflight}
        if t.deadline is not None and time.monotonic() >= t.deadline:
            return                # the deadline action handles expiry
        group = self._sup.group(t.model)
        replica = self._pick(group, exclude=busy)
        if replica is None:
            return
        _STATS["fleet_hedges"] += 1
        self._attempt(t, replica, is_hedge=True)

    def _expire(self, t):
        losers = self._resolve(t, exc=DeadlineExceeded(
            "request deadline passed before any replica answered "
            f"({(time.monotonic() - t.t0) * 1e3:.1f}ms since admission)"))
        if losers is not None:
            _STATS["fleet_deadline_exceeded"] += 1

    def _resolve(self, t, result=None, exc=None):
        """First writer wins; cancels any still-inflight twin attempts.
        Returns the cancelled list on success, None when already
        resolved."""
        with self._lock:
            if t.resolved:
                return None
            t.resolved = True
            t.data = None  # the expiry closure outlives resolution by up
            losers = list(t.inflight)  # to the full deadline: don't let
            t.inflight = []            # it pin the request payload too
            self._outstanding.discard(t)
        if t.span is not None:
            t.span.end(outcome="ok" if exc is None else type(exc).__name__)
        for _r, f, _h in losers:
            f.cancel()
        _try_resolve(t.future, result=result, exc=exc)
        return losers

    # -------------------------------------------------------------------- close
    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pending = list(self._outstanding)
            self._outstanding.clear()
        err = FleetClosed("fleet closed with the request outstanding")
        for t in pending:
            with self._lock:
                if t.resolved:
                    continue
                t.resolved = True
                t.data = None
                losers = list(t.inflight)
                t.inflight = []
            if t.span is not None:
                t.span.end(outcome="FleetClosed")
            for _r, f, _h in losers:
                f.cancel()
            _try_resolve(t.future, exc=err)
        if self._owns_sched:
            self._sched.close()


# ----------------------------------------------------------------------- fleet

class Fleet:
    """The façade: N supervised replicas per model behind a router.

    ``factories`` is one zero-arg callable returning a ready Predictor
    (model name ``'default'``) or a dict ``{model: factory}``; the
    factory runs once per replica and again on every restart. In
    ``mode='process'`` the factory must be picklable (a module-level
    function).

    A model may serve several DTYPE VARIANTS side by side — e.g. bf16
    and calibrated-int8 replicas of the same network: nest the factories
    as
    ``{model: {variant: factory}}`` and address them with
    ``submit(..., model=m, variant=v)``. Each variant is its own replica
    group (own breakers, probes, restarts); health probes and the NaN
    sentinel run on the DEQUANTIZED fp32 outputs, so an int8 variant is
    supervised exactly like its bf16 sibling.

    >>> fleet = serving.Fleet(make_predictor, replicas=4)
    >>> outs = fleet.submit(batch, deadline_ms=50.0).result()
    >>> fleet.close()
    """

    def __init__(self, factories, replicas=None, mode=None, kvstore=None,
                 retries=None, backoff_ms=None, backoff_cap_ms=None,
                 hedge_ms=None, breaker_k=None, breaker_cooldown_ms=None,
                 probe_interval_ms=None, probe_timeout=None,
                 drain_timeout=None, probe_strikes=2, server_kw=None):
        if callable(factories):
            factories = {"default": factories}
        # dtype variants: {model: {variant: factory}} flattens to one
        # replica group per "model@variant" (shared addressing with
        # submit(model=, variant=))
        flat = {}
        for model, f in (factories or {}).items():
            if isinstance(f, dict):
                for variant, vf in f.items():
                    flat[_variant_key(model, variant)] = vf
            else:
                flat[model] = f
        factories = flat
        if not factories:
            raise MXNetError("Fleet needs at least one model factory")
        n = int(replicas if replicas is not None
                else _env_int("MXNET_TPU_TORCH_FLEET_REPLICAS", 2))
        if n < 1:
            raise MXNetError(f"Fleet needs >= 1 replica per model, got {n}")
        mode = (mode or os.environ.get("MXNET_TPU_TORCH_FLEET_MODE",
                                       "thread") or "thread").strip().lower()
        if mode not in ("thread", "process"):
            raise MXNetError(
                f"fleet mode must be 'thread' or 'process', got {mode!r}")
        k = (breaker_k if breaker_k is not None
             else _env_int("MXNET_TPU_TORCH_FLEET_BREAKER_K", 3))
        cooldown_s = (
            breaker_cooldown_ms if breaker_cooldown_ms is not None
            else _env_float("MXNET_TPU_TORCH_FLEET_BREAKER_COOLDOWN_MS",
                            1000.0)) / 1e3
        cls = _ThreadReplica if mode == "thread" else _ProcessReplica
        rid = itertools.count()
        groups = {}
        for model in sorted(factories):
            members = [cls(model, next(rid), factories[model], server_kw,
                           _Breaker(k, cooldown_s)) for _ in range(n)]
            groups[model] = _Group(model, members)
        interval_s = (
            probe_interval_ms if probe_interval_ms is not None
            else _env_float("MXNET_TPU_TORCH_FLEET_PROBE_INTERVAL_MS",
                            200.0)) / 1e3
        self.mode = mode
        # retained so scale_to can mint new replicas identical to the
        # founders (same factory, breaker policy, server config, and a
        # continuing rid sequence)
        self._factories = factories
        self._server_kw = server_kw
        self._replica_cls = cls
        self._rid = rid
        self._breaker_k = k
        self._breaker_cooldown_s = cooldown_s
        self._sup = ReplicaSupervisor(
            groups, kvstore=kvstore, probe_interval_s=interval_s,
            probe_timeout_s=probe_timeout, drain_timeout_s=drain_timeout,
            probe_strikes=probe_strikes)
        self._sup.start()
        self._router = Router(self._sup, retries=retries,
                              backoff_ms=backoff_ms,
                              backoff_cap_ms=backoff_cap_ms,
                              hedge_ms=hedge_ms)
        self._closed = False
        _register_fleet(self)

    # ------------------------------------------------------------------ serving
    def submit(self, data, deadline_ms=None, model="default",
               variant=None):
        """Route one request (array, or dict name -> array, WITH batch
        axis). Returns a Future of the output list; it always terminates
        in a result or a structured error. ``variant`` picks one dtype
        variant of ``model`` (``{model: {variant: factory}}``
        construction)."""
        return self._router.submit(data, deadline_ms=deadline_ms,
                                   model=model, variant=variant)

    def variants(self, model="default"):
        """Dtype variants served for ``model`` (empty when the model was
        registered without variants)."""
        prefix = f"{model}@"
        return sorted(m[len(prefix):] for m in self._sup.models()
                      if m.startswith(prefix))

    @property
    def supervisor(self):
        return self._sup

    @property
    def router(self):
        return self._router

    def models(self):
        return self._sup.models()

    def replicas(self, model="default", variant=None):
        return self._sup.replicas(_variant_key(model, variant))

    def replica_states(self, model="default", variant=None):
        """Per-replica states; a replica draining for SCALE (autoscaler
        removal, not sickness) reports the distinct ``DRAINING(scale)``."""
        return [r.display_state
                for r in self._sup.replicas(_variant_key(model, variant))]

    def replica_count(self, model="default", variant=None):
        """Members of the group that are IN the fleet (scale-draining
        leavers excluded) — the autoscaler's notion of current size."""
        return len([r for r in self._sup.replicas(_variant_key(model,
                                                               variant))
                    if not r.scale_drain])

    def scale_to(self, target, model="default", variant=None):
        """Scale one replica group to ``target`` members (the actuator
        under serving.operator.Autoscaler, also an operator hook).

        Scale-up mints replicas identical to the founders, builds each
        (its buckets captured), and admits it only after a passing
        half-open probe: the router never sees a cold or sick newcomer.
        Scale-down drains the least-loaded member (``DRAINING(scale)``): in-flight requests complete under the
        drain deadline, and the leaver never counts against the health
        floor. Returns the resulting member count."""
        key = _variant_key(model, variant)
        target = int(target)
        if target < 1:
            raise MXNetError(
                f"scale_to needs target >= 1 replica, got {target}")
        while self.replica_count(model, variant) < target:
            replica = self._replica_cls(
                key, next(self._rid), self._factories[key],
                self._server_kw,
                _Breaker(self._breaker_k, self._breaker_cooldown_s))
            self._sup.add_replica(key, replica)
        while self.replica_count(model, variant) > target:
            if self._sup.remove_replica(key) is None:
                break
        return self.replica_count(model, variant)

    def fail_replica(self, rid=0, model="default", reason="operator",
                     variant=None):
        """Operator hook: drain, restart and re-admit one replica (the
        same machinery a failure detection triggers)."""
        model = _variant_key(model, variant)
        for r in self._sup.replicas(model):
            if r.rid == rid:
                return self._sup.fail_replica(r, reason=reason)
        raise MXNetError(f"no replica {rid} for model {model!r}")

    def wait_healthy(self, timeout=10.0, model=None):
        """Block until every replica (of ``model``, or all models) is
        HEALTHY; returns True on success, False on timeout."""
        models = [model] if model is not None else self.models()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(r.state == "HEALTHY"
                   for m in models for r in self._sup.replicas(m)
                   if not r.scale_drain):
                return True
            time.sleep(0.02)
        return False

    # -------------------------------------------------------------------- stats
    def _collect_latencies(self, out_samples, out_summaries):
        for model in self.models():
            for r in self._sup.replicas(model):
                lat = r.latency_snapshot()
                out_samples.extend(lat)
                out_summaries.append(
                    f"{model}/{r.rid} p50={_percentile_us(lat, 0.50)}us "
                    f"p99={_percentile_us(lat, 0.99)}us n={len(lat)}")

    def _reset_latencies(self):
        for model in self.models():
            for r in self._sup.replicas(model):
                r.reset_latencies()

    # -------------------------------------------------------------------- close
    def close(self, timeout=10.0):
        """Stop the router (outstanding requests fail with FleetClosed),
        then drain and stop every replica. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._router.close()
        self._sup.close(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------- streaming decode front

class StreamRouter:
    """Multi-replica front for streamed generation.

    Owns N :class:`serving.DecodeBatcher` replicas built from one
    zero-arg factory returning a ready ``DecodePredictor`` (run again by
    :meth:`revive` after a death). ``submit_stream`` routes each new
    sequence to
    the live replica with the least outstanding work, and every replica
    gets this router installed as its death sink: when a decode engine
    dies mid-stream (``decode_replica_death`` chaos, or any engine
    crash), each incomplete stream is RESUBMITTED to another live
    replica — prompt plus tokens-already-streamed re-prefill there, the
    consumer's :class:`TokenStream` keeps yielding with only a latency
    blip, and ``decode_reroutes`` counts the saves. With no live replica
    left, streams fail with the original error instead of hanging.
    """

    def __init__(self, factory, replicas=2, ttft_slo_ms=None):
        from .batcher import DecodeBatcher

        n = int(replicas)
        if n < 1:
            raise MXNetError(f"StreamRouter needs >= 1 replica, got {n}")
        self._factory = factory
        self._ttft_slo_ms = ttft_slo_ms
        self._decode_cls = DecodeBatcher
        self._lock = threading.Lock()
        self._closed = False
        self._batchers = [self._build() for _ in range(n)]

    def _build(self):
        bat = self._decode_cls(self._factory(),
                               ttft_slo_ms=self._ttft_slo_ms)
        bat.death_sink = lambda items, exc, _bat=bat: \
            self._reroute(_bat, items, exc)
        return bat

    def _pick(self, exclude=()):
        with self._lock:
            live = [b for b in self._batchers
                    if not b.dead and b not in exclude]
        if not live:
            return None
        return min(live, key=lambda b: b.outstanding)

    def submit_stream(self, prompt, max_new_tokens, eos_id=None):
        """Route one generation request; returns its
        :class:`serving.TokenStream`."""
        if self._closed:
            raise FleetClosed("StreamRouter is closed")
        bat = self._pick()
        if bat is None:
            raise FleetOverloaded("decode", len(self._batchers),
                                  0, len(self._batchers))
        _STATS["fleet_requests"] += 1
        return bat.submit(prompt, max_new_tokens, eos_id=eos_id)

    def _reroute(self, dead_bat, items, exc):
        for stream, prompt, remaining, eos_id in items:
            target = None if self._closed else \
                self._pick(exclude=(dead_bat,))
            if target is None:
                if not stream.finished:
                    stream._fail(exc)
                continue
            try:
                target.submit(prompt, remaining, eos_id=eos_id,
                              stream=stream)
                _STATS["decode_reroutes"] += 1
            except Exception:
                if not stream.finished:
                    stream._fail(exc)

    def revive(self):
        """Rebuild every dead replica from the factory (the supervisor
        restart analogue for decode engines). Returns how many were
        rebuilt."""
        rebuilt = 0
        with self._lock:
            for i, b in enumerate(self._batchers):
                if b.dead and not self._closed:
                    self._batchers[i] = self._build()
                    rebuilt += 1
        _STATS["fleet_restarts"] += rebuilt
        return rebuilt

    @property
    def live_replicas(self):
        with self._lock:
            return sum(1 for b in self._batchers if not b.dead)

    @property
    def replicas(self):
        with self._lock:
            return list(self._batchers)

    def close(self, drain=True):
        self._closed = True
        with self._lock:
            batchers = list(self._batchers)
        for b in batchers:
            b.close(drain=drain)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=exc[0] is None)

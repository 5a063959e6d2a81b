"""Stall watchdog: no guarded phase may block forever (port of
``mxnet_tpu/resilience/watchdog.py``: the step, batch and probe phases).

One daemon monitor thread watches every guarded scope. When a scope
outlives its phase's deadline, the monitor writes a crash report (JSON:
phase, detail, the flight recorder's tail, the open incidents, the runtime
counters, the ``MXNET_TPU_TORCH_*`` environment) into
``MXNET_TPU_TORCH_CRASH_DIR`` (default ``$TMPDIR/mxnet_tpu_torch_crash``)
and raises a structured :class:`StallError` in the stalled thread
(``PyThreadState_SetAsyncExc``), so the blocked batch returns with an
error instead of hanging its queue.

Phases and their deadlines (seconds; unset or ``0`` disables):

- ``step`` — ``MXNET_TPU_TORCH_WATCHDOG_STEP_TIMEOUT`` (gluon
  ``Trainer.step``/``update``, ``parallel.ShardedTrainer.step``, the
  captured gluon step); a stalled gluon step with a rollback-policy
  sentinel attached resumes from the last checkpoint
  (:func:`note_rollback` amends the crash report);
- ``batch`` — ``MXNET_TPU_TORCH_WATCHDOG_BATCH_TIMEOUT``
  (``serving.BatchServer`` batch execution and ``close()`` drain);
- ``probe`` — ``MXNET_TPU_TORCH_WATCHDOG_PROBE_TIMEOUT`` (the fleet's
  replica health probes; the batch deadline when unset).

The raise lands at a Python bytecode boundary: it interrupts Python-level
waits (an injected hang, a lock, a retry loop) but not a thread parked
inside one C call such as a CUDA synchronize; the crash report is written
either way.

Peer bookkeeping: ``mark_peer_dead`` / ``dead_peers`` / ``reset_peers``
record which ranks (the fleet: which replica ids) are out; the supervisor
marks a draining replica dead and a kvstore's ``excise_dead_peers``
re-admits it. :class:`PeerLostError` is what a step raises when its
device failed the integrity self-test. Not ported (the rest of ROADMAP
Queue 1 item 12): the ``collective`` guard of the dist store and the pod
(host-level) liveness layer.
"""
from __future__ import annotations

import contextlib
import ctypes
import itertools
import json
import os
import tempfile
import threading
import time

from ..observability import flight as _obs_flight

__all__ = ["StallError", "PeerLostError", "guard", "timeout_for",
           "crash_dir", "mark_peer_dead", "dead_peers", "reset_peers",
           "note_step", "note_rollback", "stats", "reset_stats", "PHASES"]

PHASES = ("step", "batch", "probe")

_STATS = {
    "watchdog_guards": 0,         # scopes armed (a timeout was configured)
    "watchdog_stalls": 0,         # deadlines that expired
    "watchdog_crash_reports": 0,  # reports successfully written
    "watchdog_peer_lost": 0,      # ranks declared dead
    "watchdog_rollbacks": 0,      # stalls recovered from a checkpoint
}

_LAST_STEP = None


def stats():
    return dict(_STATS)


def reset_stats():
    for k in _STATS:
        _STATS[k] = 0


# PyThreadState_SetAsyncExc only accepts an exception CLASS (CPython
# instantiates it with no arguments where it is delivered), so the monitor
# parks the stall details here, keyed by the stalled thread's ident, for
# __init__ to pick up.
_PENDING_STALLS: dict = {}


class StallError(RuntimeError):
    """A guarded phase exceeded its watchdog deadline.

    Attributes: ``phase``, ``detail`` (the guarded call site), ``timeout``
    (seconds) and ``report_path`` (the crash report, or None)."""

    phase = None
    detail = None
    timeout = None
    report_path = None

    def __init__(self, *args):
        if not args:
            info = _PENDING_STALLS.pop(threading.get_ident(), None)
            if info is not None:
                self.__dict__.update(info)
                args = (info.get("message", "watchdog stall"),)
        super().__init__(*args)


class PeerLostError(RuntimeError):
    """A rank (on one card: the device itself, after a failed integrity
    self-test) is gone; ``.ranks`` names it."""

    ranks = ()


_PEER_LOCK = threading.Lock()
_DEAD_PEERS: set = set()


def mark_peer_dead(rank):
    """Record that ``rank`` is gone (one ``peer`` flight event)."""
    rank = int(rank)
    with _PEER_LOCK:
        newly_dead = rank not in _DEAD_PEERS
        if newly_dead:
            _DEAD_PEERS.add(rank)
            _STATS["watchdog_peer_lost"] += 1
    if newly_dead:
        _obs_flight.record("peer", rank=rank, status="dead")


def dead_peers():
    with _PEER_LOCK:
        return sorted(_DEAD_PEERS)


def reset_peers(ranks=None):
    """Forget dead-peer bookkeeping; with ``ranks``, only those (re-admitting
    one recovered replica must not re-admit a rank still dead)."""
    with _PEER_LOCK:
        if ranks is None:
            _DEAD_PEERS.clear()
        else:
            for r in ranks:
                _DEAD_PEERS.discard(int(r))


def note_step(step):
    """Record the current training step, for crash reports of guards that
    do not know it."""
    global _LAST_STEP
    _LAST_STEP = int(step)


def note_rollback(err, manifest):
    """A stall recovered by restoring a checkpoint: counts
    ``watchdog_rollbacks`` and amends the stall's crash report with the
    restored step and tag."""
    _STATS["watchdog_rollbacks"] += 1
    path = getattr(err, "report_path", None)
    if not path:
        return
    try:
        with open(path) as f:
            report = json.load(f)
        report["recovered_by"] = {"action": "checkpoint_rollback",
                                  "restored_step": manifest.get("step"),
                                  "restored_tag": manifest.get("tag")}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1, default=str)
        os.replace(tmp, path)
    except (OSError, ValueError):
        pass  # the report is forensics, never control flow


# ------------------------------------------------------------------- guarding

_TOKENS = itertools.count(1)
_COND = threading.Condition()
_GUARDS: dict = {}
_MONITOR = None
_WAKE_AT = None    # monotonic time the monitor is currently sleeping toward


class _Guard:
    __slots__ = ("token", "phase", "detail", "timeout", "deadline",
                 "thread_id", "thread_name", "step", "fired", "cancelled",
                 "cls", "info")

    def __init__(self, phase, timeout, detail, step):
        self.token = next(_TOKENS)
        self.phase = phase
        self.detail = detail
        self.timeout = float(timeout)
        self.deadline = time.monotonic() + self.timeout
        t = threading.current_thread()
        self.thread_id = t.ident
        self.thread_name = t.name
        self.step = step
        self.fired = False      # monitor expired this guard
        self.cancelled = False  # guarded thread resolved its own fate
        self.cls = None
        self.info = None


def timeout_for(phase):
    """The configured deadline (seconds) for ``phase``, or None when the
    watchdog is disabled for it. Read from the environment on every call
    so tests (and live operators) can arm it after import."""
    raw = os.environ.get(
        f"MXNET_TPU_TORCH_WATCHDOG_{phase.upper()}_TIMEOUT", "").strip()
    if not raw:
        return None
    try:
        t = float(raw)
    except ValueError:
        return None
    return t if t > 0 else None


@contextlib.contextmanager
def guard(phase, timeout=None, detail=None, step=None):
    """Arm the watchdog around a block. ``timeout`` defaults to the
    phase's env deadline; with no deadline configured this is a no-op
    (one env read). On expiry the monitor thread writes a crash report
    and asynchronously raises StallError inside the guarded thread."""
    if timeout is None:
        timeout = timeout_for(phase)
    if timeout is None:
        yield None
        return
    g = _Guard(phase, timeout, detail, step)
    with _COND:
        _GUARDS[g.token] = g
        _STATS["watchdog_guards"] += 1
        _ensure_monitor()
        # Wake the monitor only when this deadline is EARLIER than what
        # it already sleeps toward (a notify per guard would hand the GIL
        # to the monitor on every batch); a stale-early wake just
        # recomputes and sleeps again.
        if _WAKE_AT is None or g.deadline < _WAKE_AT:
            _COND.notify_all()
    try:
        yield g
    except BaseException as body_exc:
        with _COND:
            _GUARDS.pop(g.token, None)
            if g.fired and getattr(body_exc, "guard_token",
                                   None) != g.token:
                # the body is unwinding with an error that is NOT this
                # guard's own delivered stall (its own failure, or a
                # nested/outer guard's StallError): cancel THIS guard's
                # delivery so it cannot erupt at an arbitrary later
                # bytecode of the caller. Holding _COND makes this
                # atomic with _fire's cancelled-check, so the monitor
                # either sees the cancel or has already delivered —
                # never delivers after it.
                g.cancelled = True
                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(threading.get_ident()), None)
                _PENDING_STALLS.pop(threading.get_ident(), None)
        raise
    else:
        with _COND:
            _GUARDS.pop(g.token, None)
            fired = g.fired
        if fired:
            _absorb_stall(g)


def _absorb_stall(g):
    """The block completed in the same instant the monitor fired: the
    async exception is (about to be) pending on this thread — possibly
    delayed behind the crash-report write. Park on interruptible sleeps
    so it is delivered *here*, inside the guard, rather than at some
    arbitrary later bytecode of the caller. If it never arrives, cancel
    the delivery (atomically with _fire's cancelled-check) and surface
    the stall synchronously instead."""
    end = time.monotonic() + _REPORT_BUDGET + 2.0
    while time.monotonic() < end:
        time.sleep(0.001)  # a bytecode boundary: delivery happens here
    with _COND:
        g.cancelled = True
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(threading.get_ident()), None)
        _PENDING_STALLS.pop(threading.get_ident(), None)
    err = (g.cls or StallError)(
        (g.info or {}).get("message",
                           f"{g.phase} exceeded its {g.timeout:.3g}s "
                           "watchdog deadline"))
    err.__dict__.update(g.info or {"phase": g.phase, "timeout": g.timeout,
                                   "detail": g.detail})
    raise err


# -------------------------------------------------------------------- monitor

def _ensure_monitor():
    """Start the daemon monitor thread lazily (called under _COND)."""
    global _MONITOR
    if _MONITOR is None or not _MONITOR.is_alive():
        _MONITOR = threading.Thread(target=_monitor_loop,
                                    name="mxnet-torch-watchdog", daemon=True)
        _MONITOR.start()


def _monitor_loop():
    global _WAKE_AT
    while True:
        expired = []
        with _COND:
            if not _GUARDS:
                _WAKE_AT = None
                _COND.wait(timeout=60.0)
                continue
            now = time.monotonic()
            soonest = min(g.deadline for g in _GUARDS.values())
            if soonest > now:
                _WAKE_AT = soonest
                _COND.wait(timeout=min(soonest - now, 60.0))
                _WAKE_AT = None
                continue
            for token in [t for t, g in _GUARDS.items()
                          if g.deadline <= now]:
                g = _GUARDS.pop(token)
                g.fired = True
                expired.append(g)
        for g in expired:
            try:
                _fire(g)
            except Exception:
                pass  # the monitor must survive anything


# Hard budget (seconds) for writing one crash report. The write runs in
# a helper thread so a wedged import lock or a hung crash-dir mount can
# delay the report but can never stop the monitor from unwedging the
# stalled thread — the raise is the contract, the report is forensics.
_REPORT_BUDGET = 5.0


def _fire(g):
    """One expired guard: write the crash report (time-budgeted), pick
    the error class, and raise it asynchronously in the stalled thread
    — unless the guarded thread already resolved its own fate
    (g.cancelled), in which case delivery is skipped."""
    box = {}

    def write():
        box["path"] = _write_crash_report(g)

    writer = threading.Thread(target=write, daemon=True,
                              name="mxnet-torch-crash-report")
    writer.start()
    writer.join(_REPORT_BUDGET)
    report_path = box.get("path")
    _STATS["watchdog_stalls"] += 1
    _obs_flight.record("stall", phase=g.phase, detail=g.detail,
                       timeout_s=g.timeout, step=g.step)
    cls = StallError
    what = g.detail or g.phase
    message = (f"{what} stalled: no progress within its "
               f"{g.timeout:.3g}s '{g.phase}' watchdog deadline "
               f"(crash report: {report_path})")
    extra = {}
    info = {"message": message, "phase": g.phase, "detail": g.detail,
            "timeout": g.timeout, "report_path": report_path,
            "guard_token": g.token}  # lets cleanup tell its own stall
    info.update(extra)               # apart from a nested guard's
    g.cls = cls
    g.info = info
    with _COND:
        # atomic with the guard-side cancel: either we deliver here and
        # the cleanup's SetAsyncExc(None) finds nothing or clears it, or
        # the cancel came first and we must not deliver at all
        if g.cancelled:
            return
        _PENDING_STALLS[g.thread_id] = info
        res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(g.thread_id), ctypes.py_object(cls))
        if res != 1:
            # 0: thread already exited; >1: multiple states touched — undo
            if res > 1:
                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(g.thread_id), None)
            _PENDING_STALLS.pop(g.thread_id, None)


# --------------------------------------------------------------- crash report

def crash_dir():
    return (os.environ.get("MXNET_TPU_TORCH_CRASH_DIR", "").strip()
            or os.path.join(tempfile.gettempdir(), "mxnet_tpu_torch_crash"))


def _env_snapshot():
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith(("MXNET_TPU_TORCH_", "CUDA_"))}


def _write_crash_report(g):
    try:
        try:
            from ..observability import runtime_counters

            counters = runtime_counters()
        except Exception:
            counters = {}
        try:
            flight_tail = _obs_flight.snapshot(limit=256)
        except Exception:
            flight_tail = []
        try:
            from ..observability import alerts as _obs_alerts

            incident_tail = _obs_alerts.incidents(limit=8)
        except Exception:
            incident_tail = []
        report = {
            "schema_version": 1,
            "kind": "stall",
            "phase": g.phase,
            "detail": g.detail,
            "timeout_s": g.timeout,
            "step": g.step if g.step is not None else _LAST_STEP,
            "pid": os.getpid(),
            "thread": {"ident": g.thread_id, "name": g.thread_name},
            "wallclock": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "dead_peers": dead_peers(),
            "flight_recorder": flight_tail,
            "incidents": incident_tail,
            "counters": counters,
            "env": _env_snapshot(),
        }
        d = crash_dir()
        os.makedirs(d, exist_ok=True)
        name = (f"crash-{time.strftime('%Y%m%d-%H%M%S')}-{g.phase}"
                f"-pid{os.getpid()}-{g.token}.json")
        path = os.path.join(d, name)
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1, default=str)
        os.replace(tmp, path)
        _STATS["watchdog_crash_reports"] += 1
        return path
    except Exception:
        return None

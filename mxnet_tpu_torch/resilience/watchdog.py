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
re-admits it.

Liveness of a job of several processes (``mxnet_tpu``'s pod layer, over
ranks). ``mxnet_tpu`` is one process over many devices; the port runs a
process a rank, so a dead peer is a process that exited or hangs, never a
name in a table. :func:`configure_liveness` (every multi-rank
``ShardedTrainer`` and the dist store call it through :func:`join_job`)
gives this process its rank, the world size and a job directory
(``MXNET_TPU_TORCH_HEARTBEAT_DIR``, default
``$TMPDIR/mxnet_tpu_torch_pod``, one ``job-<token>`` directory a job, the
token agreed through the job's rendezvous store). Each rank publishes
``rank-<r>.gen<g>.hb`` there (its pid, host name and time); a peer whose
pid is gone (on this machine; a zombie counts as gone) is dead at once,
one whose beat is older than ``MXNET_TPU_TORCH_HOST_HEARTBEAT_TIMEOUT``
seconds (unset: off) is presumed dead. :func:`configure_pod` adds host
failure domains: ``devices_per_host`` consecutive ranks a host, and a
dead rank takes its whole host down. Every collective of
:mod:`..parallel.collectives` waits through :func:`wait_work`: in slices
of 0.1 s, scanning the beats between slices, so a survivor leaves a
collective on a dead peer as :class:`PeerLostError` (``ranks``,
``hosts``) within a slice, whichever peer it was waiting on, and a gloo
error from a peer that closed its connection leaves the same way. With
``MXNET_TPU_TORCH_WATCHDOG_COLLECTIVE_TIMEOUT`` set, a collective that
makes no progress for that long raises :class:`StallError` (or
``PeerLostError`` naming a suspect host). :func:`pod_barrier` and
:func:`settle_dead` align the survivors (files ``barrier-<tag>-rank<r>``
in the job directory) before a recovery, so all of them shrink around
the same dead set; the job directory also holds the rendezvous file of
each later generation's process group (``parallel.mesh``).
"""
from __future__ import annotations

import contextlib
import ctypes
import itertools
import json
import os
import socket
import tempfile
import threading
import time

from ..observability import flight as _obs_flight
from . import faults as _faults

__all__ = ["StallError", "PeerLostError", "guard", "timeout_for",
           "crash_dir", "mark_peer_dead", "dead_peers", "reset_peers",
           "note_step", "note_rollback", "note_peer_recovery", "stats",
           "reset_stats", "PHASES", "configure_liveness", "join_job",
           "liveness", "job_dir", "configure_pod", "pod_info",
           "pod_snapshot", "reset_pod", "mark_host_dead", "dead_hosts",
           "reset_hosts", "coordinator", "heartbeat", "check_hosts",
           "check_peers", "collective_guard", "collective_timeout",
           "wait_work", "pod_barrier", "settle_dead"]

PHASES = ("step", "batch", "probe", "collective")

_STATS = {
    "watchdog_guards": 0,         # scopes armed (a timeout was configured)
    "watchdog_stalls": 0,         # deadlines that expired
    "watchdog_crash_reports": 0,  # reports successfully written
    "watchdog_peer_lost": 0,      # ranks declared dead
    "watchdog_rollbacks": 0,      # stalls recovered from a checkpoint
    "watchdog_peer_recoveries": 0,  # peer losses survived by mesh shrink
    "watchdog_host_lost": 0,      # pod hosts declared dead
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


class PeerLostError(StallError):
    """A collective lost a peer: the named rank(s) are dead, so the
    operation would have blocked forever (or a rank failed the integrity
    self-test and is excised). ``ranks`` lists the dead ranks; ``hosts``
    the dead pod hosts when the loss is a whole failure domain (host-level
    recovery excises every rank of that host in one mesh shrink)."""

    ranks = ()
    hosts = ()


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


def _peer_lost_error(ranks, detail, stalled=None, hosts=()):
    ranks, hosts = tuple(ranks), tuple(hosts)
    what = detail or "collective"
    who = (f"pod host(s) {list(hosts)} (rank(s) {list(ranks)})" if hosts
           else f"peer rank(s) {list(ranks)}")
    if stalled is None:
        msg = (f"{who} lost: refusing to enter {what} that would block "
               "forever on the dead worker(s)")
    else:
        msg = (f"{who} lost: {what} stalled past its {stalled:.3g}s "
               "deadline waiting on the dead worker(s)")
    err = PeerLostError(msg)
    err.phase = "collective"
    err.detail = detail
    err.ranks = ranks
    err.hosts = hosts
    err.timeout = stalled
    return err


# ------------------------------------------------------------ liveness, pod

# This process's place in a job of several processes: {"world", "rank",
# "dir" (the job directory, or None: in-memory beats), "generation",
# "hosts" (None, or {"num_hosts", "this_host", "per"}: the pod)}. The
# dead-host set is sticky until reset_hosts() or a re-declaration.
_LIVE = None
_DEAD_HOSTS: set = set()
_BARRIER_SEQ = itertools.count(1)
_SLICE = 0.1              # seconds a collective waits between scans
_PEER_GRACE = 5.0         # seconds a backend error waits for a dead beat
_BEAT_EVERY = 1.0         # seconds between this process's routine beats
_LAST_BEAT = None         # monotonic time of this process's last beat
# (job dir, generation, rank) -> the peer's beat as first read: its pid and
# host name stay for the generation, so a scan re-reads no file for them
_PEER_BEATS: dict = {}
_HOSTNAME = socket.gethostname()


def _pid_alive(pid):
    """Is ``pid`` a live process of this machine? A zombie (exited, not
    yet reaped by its parent) is not."""
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except (OSError, ValueError, TypeError):
        return False
    try:
        with open(f"/proc/{int(pid)}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
        return state not in ("Z", "X")
    except (OSError, IndexError):
        return True


def _env_float(name, default):
    raw = os.environ.get(name, "").strip()
    try:
        return float(raw) if raw else float(default)
    except ValueError:
        return float(default)


def collective_timeout():
    """The collective deadline in seconds (``MXNET_TPU_TORCH_WATCHDOG_
    COLLECTIVE_TIMEOUT``), else 300: also the timeout given to every gloo
    group the port makes, where gloo's own default (30 minutes) would turn
    a wedged peer into a hung job."""
    t = timeout_for("collective")
    return 300.0 if t is None else t


def configure_liveness(world, rank, heartbeat_dir=None, generation=0):
    """Declare this process rank ``rank`` of a job of ``world`` processes
    (ranks are their own failure domains until :func:`configure_pod`)
    and publish its first beat. ``heartbeat_dir`` is the job directory
    (None: ``MXNET_TPU_TORCH_HEARTBEAT_DIR``; neither: beats stay in
    memory). Re-declaring (a recovery, at the next ``generation``)
    forgets the dead hosts and the pod. Returns :func:`liveness`."""
    global _LIVE
    world, rank = int(world), int(rank)
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} out of range for a world of {world}")
    if heartbeat_dir is None:
        heartbeat_dir = (os.environ.get("MXNET_TPU_TORCH_HEARTBEAT_DIR", "")
                         .strip() or None)
    with _PEER_LOCK:
        _LIVE = {"world": world, "rank": rank, "dir": heartbeat_dir,
                 "generation": int(generation), "hosts": None}
        _DEAD_HOSTS.clear()
    if heartbeat_dir:
        os.makedirs(heartbeat_dir, exist_ok=True)
    heartbeat()
    return liveness()


def join_job(world, rank):
    """:func:`configure_liveness` for a ``torch.distributed`` job at
    generation 0, idempotent: the job directory is
    ``<MXNET_TPU_TORCH_HEARTBEAT_DIR or $TMPDIR/mxnet_tpu_torch_pod>/
    job-<token>``, rank 0 drawing the token and the others reading it
    from the job's rendezvous store (so two jobs never share beats)."""
    info = liveness()
    if info is not None and info["world"] == int(world) \
            and info["rank"] == int(rank):
        return info
    import uuid

    import torch.distributed as dist

    store = dist.distributed_c10d._get_default_store()
    key = "mxnet_tpu_torch/liveness/job"
    if int(rank) == 0:
        store.set(key, uuid.uuid4().hex[:12])
    token = store.get(key).decode()
    base = (os.environ.get("MXNET_TPU_TORCH_HEARTBEAT_DIR", "").strip()
            or os.path.join(tempfile.gettempdir(), "mxnet_tpu_torch_pod"))
    return configure_liveness(world, rank, os.path.join(base, f"job-{token}"))


def liveness():
    """This process's declared place ({world, rank, dir, generation,
    hosts}), or None."""
    with _PEER_LOCK:
        if _LIVE is None:
            return None
        out = dict(_LIVE)
        out["hosts"] = dict(_LIVE["hosts"]) if _LIVE["hosts"] else None
        return out


def job_dir():
    """The job directory (beats, barriers, later rendezvous), or None."""
    info = liveness()
    return None if info is None else info["dir"]


def configure_pod(num_hosts, this_host, heartbeat_dir=None, generation=0,
                  devices_per_host=1):
    """Declare this process's place in a pod of ``num_hosts`` hosts of
    ``devices_per_host`` consecutive ranks each, and reset host liveness
    (the re-admission point: a recovery that renumbers the pod re-declares
    it at the next ``generation``). A process that declared no job
    (:func:`configure_liveness`) becomes rank ``this_host *
    devices_per_host`` of one. Tags every flight event with the host and
    publishes a beat. Returns :func:`pod_info`."""
    global _LIVE
    num_hosts, this_host = int(num_hosts), int(this_host)
    per = int(devices_per_host)
    if num_hosts < 1:
        raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
    if not 0 <= this_host < num_hosts:
        raise ValueError(
            f"this_host={this_host} out of range for {num_hosts} host(s)")
    if per < 1:
        raise ValueError(f"devices_per_host must be >= 1, got {per}")
    info = liveness()
    if info is None or info["world"] != num_hosts * per \
            or info["rank"] // per != this_host \
            or heartbeat_dir not in (None, info["dir"]) \
            or int(generation) != info["generation"]:
        rank = (info["rank"] if info is not None
                and info["world"] == num_hosts * per
                and info["rank"] // per == this_host else this_host * per)
        configure_liveness(num_hosts * per, rank, heartbeat_dir
                           if heartbeat_dir is not None else
                           (None if info is None else info["dir"]),
                           generation)
    with _PEER_LOCK:
        _LIVE["hosts"] = {"num_hosts": num_hosts, "this_host": this_host,
                          "per": per}
        _DEAD_HOSTS.clear()
    _obs_flight.set_host(this_host)
    heartbeat()
    return pod_info()


def pod_info():
    """This process's declared pod place ({num_hosts, this_host,
    devices_per_host, heartbeat_dir, generation}), or None."""
    with _PEER_LOCK:
        if _LIVE is None or _LIVE["hosts"] is None:
            return None
        h = _LIVE["hosts"]
        return {"num_hosts": h["num_hosts"], "this_host": h["this_host"],
                "devices_per_host": h["per"],
                "heartbeat_dir": _LIVE["dir"],
                "generation": _LIVE["generation"]}


def pod_snapshot():
    """One pod view for metrics and alerts: configured flag, host counts,
    the sticky dead-host list, the coordinator."""
    info = pod_info()
    if info is None:
        return {"configured": False}
    dead = dead_hosts()
    live = [h for h in range(info["num_hosts"]) if h not in dead]
    return {"configured": True, "num_hosts": info["num_hosts"],
            "this_host": info["this_host"], "dead_hosts": dead,
            "live_hosts": live, "coordinator": live[0] if live else None}


def reset_pod():
    """Forget the job, the pod and all host bookkeeping (tests)."""
    global _LIVE
    with _PEER_LOCK:
        _LIVE = None
        _DEAD_HOSTS.clear()
    _obs_flight.set_host(None)


def mark_host_dead(host):
    """Record that pod ``host`` -- the failure domain, every one of its
    ranks -- is gone; sticky until :func:`reset_hosts` or a
    re-declaration."""
    host = int(host)
    with _PEER_LOCK:
        newly = host not in _DEAD_HOSTS
        if newly:
            _DEAD_HOSTS.add(host)
            _STATS["watchdog_host_lost"] += 1
    if newly:
        _obs_flight.record("peer", host=host, status="dead")


def dead_hosts():
    with _PEER_LOCK:
        return sorted(_DEAD_HOSTS)


def reset_hosts(hosts=None):
    """Forget dead-host bookkeeping; with ``hosts``, only those."""
    with _PEER_LOCK:
        if hosts is None:
            _DEAD_HOSTS.clear()
        else:
            for h in hosts:
                _DEAD_HOSTS.discard(int(h))


def coordinator():
    """The pod's coordinator: its lowest live host, or None (no pod, or
    every host dead)."""
    snap = pod_snapshot()
    return snap.get("coordinator") if snap["configured"] else None


def _host_of(rank, info=None):
    info = liveness() if info is None else info
    hosts = info["hosts"] if info else None
    return None if hosts is None else int(rank) // hosts["per"]


def _host_ranks(host, info):
    per = info["hosts"]["per"]
    return range(int(host) * per, (int(host) + 1) * per)


def heartbeat(rank=None):
    """Publish one beat for ``rank`` (default: this process's): the file
    ``rank-<r>.gen<g>.hb`` in the job directory. No-op without a job
    directory (one process is the whole job: no peer reads beats)."""
    global _LAST_BEAT
    info = liveness()
    if info is None or not info["dir"]:
        return
    r = info["rank"] if rank is None else int(rank)
    if r == info["rank"]:
        _LAST_BEAT = time.monotonic()
    d = info["dir"]
    path = os.path.join(d, f"rank-{r}.gen{info['generation']}.hb")
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump({"rank": r, "host": _host_of(r, info),
                       "pid": os.getpid(), "hostname": _HOSTNAME,
                       "time": time.time()}, f)
        os.replace(tmp, path)
    except OSError:
        pass  # a missed beat is staleness, never a crash


def _beat_if_due():
    """This process's beat, unless it beat within ``_BEAT_EVERY``."""
    if _LAST_BEAT is None or time.monotonic() - _LAST_BEAT >= _BEAT_EVERY:
        heartbeat()


def _scan_dead():
    """Read the peers' beats: a beat whose writer (on this machine) is
    gone marks its rank dead at once; one older than
    ``MXNET_TPU_TORCH_HOST_HEARTBEAT_TIMEOUT`` seconds (unset: off) is a
    presumed loss. A rank that never beat is still starting: no verdict.
    On a pod a dead rank marks its host dead. Returns the newly dead
    ranks."""
    info = liveness()
    if info is None or not info["dir"] or not os.path.isdir(info["dir"]):
        return []
    stale_after = _env_float("MXNET_TPU_TORCH_HOST_HEARTBEAT_TIMEOUT", 0.0)
    already = set(dead_peers())
    newly = []
    for r in range(info["world"]):
        if r == info["rank"] or r in already:
            continue
        path = os.path.join(info["dir"],
                            f"rank-{r}.gen{info['generation']}.hb")
        key = (info["dir"], info["generation"], r)
        beat = _PEER_BEATS.get(key)
        try:
            if beat is None:
                with open(path) as f:
                    beat = json.load(f)
                _PEER_BEATS[key] = beat
            age = time.time() - os.stat(path).st_mtime \
                if stale_after > 0 else 0.0
        except (OSError, ValueError):
            continue
        pid = beat.get("pid")
        if pid is not None and beat.get("hostname", _HOSTNAME) == _HOSTNAME \
                and not _pid_alive(pid):
            newly.append(r)
        elif stale_after > 0 and age > stale_after:
            newly.append(r)
    for r in newly:
        _mark_rank_dead(r, info)
    return newly


def _lost():
    """(dead ranks, dead hosts) as a PeerLostError names them: on a pod
    every rank of a dead host is dead."""
    info = liveness()
    ranks = set(dead_peers())
    hosts = tuple(dead_hosts()) if info and info["hosts"] else ()
    for h in hosts:
        ranks.update(_host_ranks(h, info))
    return tuple(sorted(ranks)), hosts


def check_hosts(detail=None):
    """One host-liveness consultation on a pod: scan the beats, publish
    this process's, and raise PeerLostError (``hosts`` naming every dead
    host) when the caller is about to enter an operation that would block
    forever on a dead failure domain. No-op without a pod."""
    if pod_info() is None:
        return
    _scan_dead()
    _beat_if_due()
    ranks, hosts = _lost()
    if hosts:
        raise _peer_lost_error(ranks, detail, hosts=hosts)


def check_peers(detail=None):
    """One liveness consultation at the top of a step attempt: the
    process-death fault hooks (``peer_death``, ``host_death``,
    ``coordinator_loss``: the victim process exits here, the survivors
    learn of it like of any death), then the beats, then this process's
    beat; raises PeerLostError naming every dead rank (and host) the
    caller's collectives would block on."""
    info = liveness()
    if info is not None:
        h = _host_of(info["rank"], info)
        _faults.maybe_peer_death(info["rank"])
        if h is not None:
            _faults.maybe_host_death(h)
            _faults.maybe_coordinator_loss(h, coordinator())
    _scan_dead()
    _beat_if_due()
    ranks, hosts = _lost()
    if ranks:
        raise _peer_lost_error(ranks, detail, hosts=hosts)


@contextlib.contextmanager
def collective_guard(detail=None, timeout=None):
    """``guard('collective')`` plus peer liveness: refuse to enter the
    collective when a peer is already known dead (PeerLostError, not an
    endless block), and arm the collective deadline around the body.
    It reads no beats: that is :func:`check_peers`' work, once a step or
    a push, and :func:`wait_work`'s once a wait outlasts its first
    slice."""
    ranks, hosts = _lost()
    if ranks:
        raise _peer_lost_error(ranks, detail, hosts=hosts)
    with guard("collective", timeout=timeout, detail=detail) as g:
        yield g


def _backend_lost(err, detail):
    """A backend error of a collective (gloo: a peer closed its
    connection, or gloo's own timeout): the PeerLostError it stands for
    when the beats name a dead peer within ``_PEER_GRACE`` seconds (a
    peer's exit can trail the reset its sockets sent), else None."""
    deadline = time.monotonic() + _PEER_GRACE
    while True:
        _scan_dead()
        ranks, hosts = _lost()
        if ranks:
            lost = _peer_lost_error(ranks, detail, hosts=hosts)
            lost.__cause__ = err
            return lost
        if time.monotonic() >= deadline:
            return None
        time.sleep(0.05)


def wait_work(work, detail=None, sliced=True):
    """Wait for one collective's ``Work``. Without a declared job, a plain
    ``wait()``. With one: in slices of 0.1 s, scanning the peers' beats
    between slices (PeerLostError once one is dead), past
    :func:`collective_timeout` a stall (PeerLostError naming a suspect
    host, else StallError), and a backend error turned into the
    PeerLostError it stands for. ``sliced=False`` (a point-to-point
    send or receive: gloo fails the transfer itself when its wait times
    out) waits whole and only turns a backend error."""
    if _LIVE is None:
        return work.wait()
    if not sliced:
        try:
            return work.wait()
        except RuntimeError as e:
            lost = _backend_lost(e, detail)
            if lost is not None:
                raise lost
            raise
    import datetime

    slice_ = datetime.timedelta(seconds=_SLICE)
    limit = timeout_for("collective")
    start = time.monotonic()
    while True:
        try:
            work.wait(slice_)
            return True
        except RuntimeError as e:
            if str(e).strip() != "Operation timed out!":
                lost = _backend_lost(e, detail)
                if lost is not None:
                    raise lost
                raise
        now = time.monotonic()
        _scan_dead()
        ranks, hosts = _lost()
        if ranks:
            raise _peer_lost_error(ranks, detail, hosts=hosts)
        _beat_if_due()
        if limit is not None and now - start > limit:
            _STATS["watchdog_stalls"] += 1
            suspects = _stall_suspect_hosts()
            for h in suspects:
                mark_host_dead(h)
            if suspects:
                ranks, hosts = _lost()
                raise _peer_lost_error(ranks, detail, stalled=limit,
                                       hosts=hosts)
            err = StallError(f"{detail or 'collective'} stalled: no "
                             f"progress within its {limit:.3g}s "
                             "'collective' watchdog deadline")
            err.phase, err.detail, err.timeout = "collective", detail, limit
            raise err


def _stall_suspect_hosts():
    """Hosts the pod liveness layer can blame for an expired guard: dead
    or stale beats, or the armed ``host_hang_collective`` fault's victim
    (``MXNET_TPU_TORCH_FAULT_HOST_RANK``, default 1). Never this host."""
    info = pod_info()
    if info is None:
        return []
    suspects = []
    if _faults.get("host_hang_collective") is not None:
        suspects.append(int(os.environ.get(
            "MXNET_TPU_TORCH_FAULT_HOST_RANK", "1")))
    lv = liveness()
    suspects.extend(_host_of(r, lv) for r in _scan_dead())
    out = []
    for h in suspects:
        if h != info["this_host"] and h not in out:
            out.append(h)
    return out


def _barrier_path(d, tag, rank):
    return os.path.join(d, f"barrier-{tag}-rank{rank}.json")


def settle_dead(tag=None, timeout=None):
    """Align the surviving ranks before a coordinated restart: each writes
    the dead ranks it knows of into ``barrier-<tag>-rank<r>.json`` and
    waits for every rank it believes live, scanning the beats meanwhile;
    a rank that dies or misses ``MXNET_TPU_TORCH_POD_BARRIER_TIMEOUT``
    seconds (default 60) is dead too. Returns the union of the views (a
    sorted tuple), the same on every survivor; on a pod, a host with a
    dead rank is dead whole. Without a job directory, the local view."""
    info = liveness()
    if info is None:
        return ()
    if tag is None:
        tag = f"g{info['generation']}-{next(_BARRIER_SEQ)}"
    if timeout is None:
        timeout = _env_float("MXNET_TPU_TORCH_POD_BARRIER_TIMEOUT", 60.0)
    d = info["dir"]
    _scan_dead()
    if not d:
        return _lost()[0]
    me = info["rank"]
    deadline = time.monotonic() + float(timeout)
    while True:
        dead = set(_lost()[0])
        if me in dead:      # this rank's own host is down: it leaves
            return tuple(sorted(dead))
        tmp = _barrier_path(d, tag, me) + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"dead": sorted(dead)}, f)
        os.replace(tmp, _barrier_path(d, tag, me))
        views = {}
        for r in range(info["world"]):
            if r == me or r in dead:
                continue
            try:
                with open(_barrier_path(d, tag, r)) as f:
                    views[r] = set(json.load(f)["dead"])
            except (OSError, ValueError, KeyError):
                continue
        news = set().union(*views.values()) - dead if views else set()
        for r in news:
            _mark_rank_dead(r, info)
        if news:
            continue        # rewrite this rank's view with the union first
        waiting = [r for r in range(info["world"])
                   if r != me and r not in dead and r not in views]
        if not waiting and all(v == dead for v in views.values()):
            return tuple(sorted(dead))
        if time.monotonic() >= deadline:
            for r in waiting:
                _mark_rank_dead(r, info)
            return _lost()[0]
        _scan_dead()
        time.sleep(0.05)


def _mark_rank_dead(rank, info):
    mark_peer_dead(rank)
    h = _host_of(rank, info)
    if h is not None:
        mark_host_dead(h)


def pod_barrier(live_hosts=None, timeout=None, tag=None):
    """``mxnet_tpu``'s pod barrier: align the surviving hosts before a
    coordinated restart (:func:`settle_dead` over their ranks). Without a
    job directory it returns at once. Returns the tuple of hosts that
    made it; a live host that missed it is marked dead and PeerLostError
    raised."""
    info = pod_info()
    if info is None:
        return ()
    before = set(dead_hosts())
    if live_hosts is None:
        live_hosts = [h for h in range(info["num_hosts"]) if h not in before]
    if not info["heartbeat_dir"]:
        return tuple(h for h in live_hosts if h not in before)
    settle_dead(tag=tag, timeout=timeout)
    after = set(dead_hosts())
    late = [h for h in live_hosts if h in after and h not in before]
    if late:
        ranks, hosts = _lost()
        raise _peer_lost_error(ranks, f"pod_barrier({tag})",
                               stalled=timeout, hosts=hosts)
    return tuple(h for h in live_hosts if h not in after)


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


def note_peer_recovery(err, manifest=None, old_axes=None, new_axes=None):
    """A peer loss survived by a mesh shrink: counts
    ``watchdog_peer_recoveries`` and amends the PeerLostError's crash
    report -- or, where none was written, writes a ``peer_recovery``
    report -- with the dead ranks and hosts, the old and new mesh axes and
    the checkpoint the run resumed from (capacity lost is an incident
    too). Returns the report's path, or None."""
    _STATS["watchdog_peer_recoveries"] += 1
    info = {"ranks": list(getattr(err, "ranks", ()) or ()),
            "hosts": list(getattr(err, "hosts", ()) or ()),
            "old_mesh_axes": old_axes, "new_mesh_axes": new_axes,
            "restored_step": None if manifest is None
            else manifest.get("step"),
            "restored_tag": None if manifest is None
            else manifest.get("tag")}
    _obs_flight.record("peer", status="recovered", ranks=info["ranks"],
                       hosts=info["hosts"],
                       restored_step=info["restored_step"])
    path = getattr(err, "report_path", None)
    if path and os.path.isfile(path):
        try:
            with open(path) as f:
                report = json.load(f)
            report["peer_recovery"] = info
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(report, f, indent=1, default=str)
            os.replace(tmp, path)
            return path
        except (OSError, ValueError):
            pass
    try:
        d = crash_dir()
        os.makedirs(d, exist_ok=True)
        report = {"schema_version": 1, "kind": "peer_recovery",
                  "step": _LAST_STEP, "pid": os.getpid(),
                  "wallclock": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
                  "error": str(err), "peer_recovery": info,
                  "env": _env_snapshot()}
        path = os.path.join(
            d, f"crash-{time.strftime('%Y%m%d-%H%M%S')}-peer-recovery"
            f"-pid{os.getpid()}-{next(_TOKENS)}.json")
        with open(f"{path}.tmp", "w") as f:
            json.dump(report, f, indent=1, default=str)
        os.replace(f"{path}.tmp", path)
        _STATS["watchdog_crash_reports"] += 1
        try:
            err.report_path = path
        except Exception:
            pass
        return path
    except Exception:
        return None


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
    ranks, hosts = _lost()
    if g.phase in ("collective", "step") and not ranks:
        for h in _stall_suspect_hosts():
            mark_host_dead(h)
        ranks, hosts = _lost()
    if g.phase in ("collective", "step") and ranks:
        cls = PeerLostError
        message = str(_peer_lost_error(ranks, g.detail, stalled=g.timeout,
                                       hosts=hosts))
        extra = {"ranks": ranks, "hosts": hosts}
    else:
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
            "dead_hosts": dead_hosts(),
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

"""The distributed KVStore over ``torch.distributed`` (port of
``mxnet_tpu/kvstore/dist.py``; parity: src/kvstore/kvstore_dist.h with
tools/launch.py's DMLC_* protocol).

There is no parameter server: one process a worker, every push a
synchronous all-reduce (sum) across the workers, every worker applying
the same update to the same summed value, so the replicas stay bitwise
equal (the property MXNet's dist_sync tests check,
tests/nightly/dist_sync_kvstore.py:30). ``dist``, ``dist_sync`` and
``dist_device_sync`` are this store; ``dist_async`` (ps-lite's
asynchronous server) raises.

The job is read from the launcher's environment (:func:`init_distributed`):
``DMLC_PS_ROOT_URI`` / ``DMLC_PS_ROOT_PORT``, ``DMLC_NUM_WORKER``,
``DMLC_WORKER_ID``; a bad value or a rank already claimed by a live
process on this machine raises :class:`DistConfigError` before any
socket opens. On one machine (a loopback coordinator) rank 0 binds the
rendezvous store itself and publishes the port it bound in the job's
claim directory (``coordinator.port``); the launcher's port is released
before rank 0 binds it, so when another process took it meanwhile rank 0
binds a fresh port, and the other ranks connect only to the port rank 0
published (the one whose writer is the live holder of rank 0's claim),
never to a stranger on the launcher's port. The backend is a fixed rule (:func:`backend_rule`): NCCL
when every worker has a GPU of its own, gloo otherwise -- so ranks that
share one card run over gloo, on CUDA tensors. Every rank holds the same
bits after an all-reduce: gloo's and NCCL's rings finish each chunk's sum
on one rank and copy it to the others.

The connect retries with exponential backoff inside a deadline
(``mxnet_tpu/kvstore/dist.py:178-267``): ``MXNET_TPU_TORCH_DIST_TIMEOUT``
(300 s), ``MXNET_TPU_TORCH_DIST_RETRIES`` (60), ``MXNET_TPU_TORCH_DIST_
BACKOFF`` (1 s, doubling, capped at 30, jittered over the upper half);
the ``dist_connect_timeout`` fault fails an attempt. The store declares
the job's liveness (``watchdog.join_job``); a push consults it once
(``watchdog.check_peers``: the beats and this rank's own), and each
all-reduce runs under ``watchdog.collective_guard`` with the
``hang_collective`` hook: a dead peer surfaces as ``PeerLostError`` naming
it, a wedged all-reduce as ``StallError`` past
``MXNET_TPU_TORCH_WATCHDOG_COLLECTIVE_TIMEOUT``.
``fingerprint_agree`` counts a disagreement in the integrity counters and
the flight recorder.
"""
from __future__ import annotations

import datetime
import hashlib
import json
import logging
import os
import random
import socket
import tempfile
import time

import torch

from ..ndarray.ndarray import NDArray
from ..observability import flight as _obs_flight
from ..resilience import faults as _faults
from ..resilience import watchdog as _watchdog
from .kvstore import KVStore, _pairs

__all__ = ["KVStoreDist", "DistConfigError", "init_distributed",
           "backend_rule", "state_fingerprint"]

_log = logging.getLogger("mxnet_tpu_torch.kvstore.dist")


class DistConfigError(ValueError):
    """An invalid DMLC_* / coordinator configuration, caught before the
    process group is made."""


def _coordinator_from_env():
    uri = os.environ.get("DMLC_PS_ROOT_URI")
    if uri:
        return f"{uri}:{os.environ.get('DMLC_PS_ROOT_PORT', '9000')}"
    return None


def _env_int(name):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        raise DistConfigError(
            f"{name}={raw!r} is not an integer; fix the launcher "
            "environment (the launcher sets these)") from None


def _validate_config(coordinator, num_processes, process_id):
    """``mxnet_tpu/kvstore/dist.py:75``: fail fast with a message that
    names the variable."""
    if num_processes <= 0:
        raise DistConfigError(
            f"DMLC_NUM_WORKER must be a positive integer, got "
            f"{num_processes}")
    if not 0 <= process_id < num_processes:
        raise DistConfigError(
            f"DMLC_WORKER_ID={process_id} is out of range for "
            f"DMLC_NUM_WORKER={num_processes} (ranks are 0.."
            f"{num_processes - 1}); every worker needs a distinct rank")
    host, sep, port = str(coordinator).rpartition(":")
    if not sep or not host:
        raise DistConfigError(
            f"coordinator address {coordinator!r} must be 'host:port' "
            "(set DMLC_PS_ROOT_URI / DMLC_PS_ROOT_PORT)")
    try:
        port_n = int(port)
    except ValueError:
        raise DistConfigError(
            f"coordinator port {port!r} in {coordinator!r} is not an "
            "integer (check DMLC_PS_ROOT_PORT)") from None
    if not 1 <= port_n <= 65535:
        raise DistConfigError(
            f"coordinator port {port_n} in {coordinator!r} is outside "
            "1..65535 (check DMLC_PS_ROOT_PORT)")


def _pid_alive(pid):
    try:
        os.kill(int(pid), 0)
    except (OSError, ValueError, TypeError):
        return False
    return True


def _claim_dir(coordinator):
    path = os.environ.get("MXNET_TPU_TORCH_DIST_CLAIM_DIR")
    if path:
        return path
    slug = hashlib.sha1(str(coordinator).encode("utf-8")).hexdigest()[:12]
    return os.path.join(tempfile.gettempdir(),
                        f"mxnet_tpu_torch-dist-claims-{slug}")


def _claim_rank(coordinator, num_processes, process_id):
    """Reject a duplicate rank before the handshake
    (``mxnet_tpu/kvstore/dist.py:123``): each worker creates
    ``rank-<id>.claim`` (O_EXCL, holding its pid) in a directory of the
    coordinator's; a live claim by another process raises, a claim whose
    process is gone is replaced."""
    directory = _claim_dir(coordinator)
    path = os.path.join(directory, f"rank-{int(process_id)}.claim")
    os.makedirs(directory, exist_ok=True)
    for _ in range(2):
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
        except FileExistsError:
            try:
                with open(path, encoding="utf-8") as fh:
                    claimant = fh.read().strip()
            except OSError:
                claimant = ""
            if claimant == str(os.getpid()):
                return path
            if claimant and _pid_alive(claimant):
                raise DistConfigError(
                    f"DMLC_WORKER_ID={int(process_id)} is already claimed "
                    f"by live process pid={claimant} for coordinator "
                    f"{coordinator} (claim file {path}); every worker "
                    f"needs a distinct rank in 0..{int(num_processes) - 1}")
            try:
                os.unlink(path)
            except OSError:
                pass
            continue
        try:
            os.write(fd, str(os.getpid()).encode("ascii"))
        finally:
            os.close(fd)
        return path
    raise DistConfigError(
        f"DMLC_WORKER_ID={int(process_id)} claim file {path} is contested "
        "faster than stale claims can be reaped; two workers race for the "
        "same rank")


def backend_rule(num_processes):
    """(backend, reason): "nccl" when this machine has a GPU for every
    worker, else "gloo" (NCCL cannot put two ranks on one GPU)."""
    n_gpu = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_gpu >= num_processes:
        return "nccl", f"{n_gpu} GPUs for {num_processes} workers"
    return "gloo", (f"{n_gpu} GPU(s) for {num_processes} workers: the "
                    "workers share" + (" the card" if n_gpu else " the CPU"))


_LOOPBACK = ("127.0.0.1", "localhost", "::1")


def _addr_in_use(e):
    text = str(e).lower()
    return "eaddrinuse" in text or "address already in use" in text


def _fresh_port(host):
    with socket.socket() as sock:
        sock.bind((host, 0))
        return sock.getsockname()[1]


def _port_file(coordinator):
    return os.path.join(_claim_dir(coordinator), "coordinator.port")


def _rank0_pid(coordinator):
    try:
        with open(os.path.join(_claim_dir(coordinator), "rank-0.claim"),
                  encoding="utf-8") as fh:
            return int(fh.read().strip())
    except (OSError, ValueError):
        return None


def _local_store(coordinator, num_processes, process_id, timeout):
    """The rendezvous store of a job whose coordinator is this machine:
    rank 0 binds it (on a fresh port when the launcher's was taken) and
    publishes the port; every other rank waits for the port published by
    the live holder of rank 0's claim and connects there."""
    host, _, port = str(coordinator).rpartition(":")
    port = int(port)
    delta = datetime.timedelta(seconds=timeout)
    path = _port_file(coordinator)
    if process_id == 0:
        for attempt in range(8):
            try:
                store = torch.distributed.TCPStore(
                    host, port, num_processes, is_master=True,
                    timeout=delta, wait_for_workers=False)
                break
            except Exception as e:  # noqa: BLE001 - a taken port retries
                if not _addr_in_use(e) or attempt == 7:
                    raise
                _log.warning("coordinator port %d is taken; rank 0 binds "
                             "a fresh port", port)
                port = _fresh_port(host)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"port": port, "pid": os.getpid()}, fh)
        os.replace(tmp, path)
        return store
    deadline = time.monotonic() + timeout
    while True:
        try:
            with open(path, encoding="utf-8") as fh:
                info = json.load(fh)
        except (OSError, ValueError):
            info = None
        if info is not None and info.get("pid") == _rank0_pid(coordinator) \
                and _pid_alive(info["pid"]):
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"worker {process_id}: rank 0 published no coordinator "
                f"port in {_claim_dir(coordinator)} within {timeout:.0f}s")
        time.sleep(0.02)
    return torch.distributed.TCPStore(host, int(info["port"]),
                                      num_processes, is_master=False,
                                      timeout=delta)


def _is_connect_error(e):
    msg = str(e).lower()
    return any(m in msg for m in ("deadline", "unavailable", "timed out",
                                  "timeout", "connect", "refused",
                                  "unreachable", "reset"))


_JITTER = random.Random()


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     timeout=None, max_retries=None, backoff=None):
    """Make the process group from the launcher's environment (idempotent).
    Returns False when the process was not launched as a worker.

    A rank that cannot reach the rendezvous fails in bounded time, not a
    hang: ``timeout`` (env ``MXNET_TPU_TORCH_DIST_TIMEOUT``, default 300)
    bounds the whole bootstrap, retries included; ``max_retries`` (env
    ``MXNET_TPU_TORCH_DIST_RETRIES``, default 60) connect attempts beyond
    the first are spaced by exponential backoff from ``backoff`` seconds
    (env ``MXNET_TPU_TORCH_DIST_BACKOFF``, default 1.0, capped at 30),
    each delay drawn over the upper half of its ceiling so the ranks do
    not retry in lockstep; every retry is logged. Only connection-flavoured
    errors retry; anything else surfaces at once. Raises TimeoutError
    naming the coordinator when the deadline or the retries run out."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    coordinator = coordinator or _coordinator_from_env()
    if num_processes is None:
        num_processes = _env_int("DMLC_NUM_WORKER")
    if process_id is None:
        process_id = _env_int("DMLC_WORKER_ID")
    if coordinator is None or num_processes is None or process_id is None:
        return False
    _validate_config(coordinator, num_processes, process_id)
    _claim_rank(coordinator, num_processes, process_id)
    if timeout is None:
        timeout = float(os.environ.get("MXNET_TPU_TORCH_DIST_TIMEOUT", "300"))
    if max_retries is None:
        max_retries = int(os.environ.get("MXNET_TPU_TORCH_DIST_RETRIES",
                                         "60"))
    if backoff is None:
        backoff = float(os.environ.get("MXNET_TPU_TORCH_DIST_BACKOFF", "1.0"))
    backend, why = backend_rule(num_processes)
    _log.info("worker %d/%d: backend %s (%s)", process_id, num_processes,
              backend, why)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    deadline = time.monotonic() + timeout
    attempt, last_err = 0, None
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        try:
            _faults.maybe_dist_connect_fault()
            _connect(coordinator, num_processes, process_id, backend,
                     remaining)
            return True
        except (TimeoutError, ConnectionError) as e:
            last_err = e
        except RuntimeError as e:   # DistNetworkError / DistStoreError too
            if not _is_connect_error(e):
                raise
            last_err = e
        attempt += 1
        if attempt > max_retries:
            break
        ceiling = min(backoff * (2 ** (attempt - 1)), 30.0)
        delay = min(_JITTER.uniform(ceiling / 2.0, ceiling),
                    max(0.0, deadline - time.monotonic()))
        _log.warning("init_distributed: worker %s/%s attempt %d/%d failed "
                     "(%r); next retry in %.2fs", process_id, num_processes,
                     attempt, max_retries + 1, last_err, max(0.0, delay))
        if delay > 0:
            time.sleep(delay)
    raise TimeoutError(
        f"init_distributed: worker {process_id}/{num_processes} could not "
        f"reach coordinator {coordinator} within {timeout:.1f}s ({attempt} "
        f"attempt(s), exponential backoff from {backoff:.1f}s). Last error: "
        f"{last_err!r}. Check that rank 0 is up and DMLC_PS_ROOT_URI / "
        "DMLC_PS_ROOT_PORT point at it.")


def _connect(coordinator, num_processes, process_id, backend, timeout):
    """One attempt at the rendezvous and the process group."""
    import torch.distributed as dist

    delta = datetime.timedelta(seconds=timeout)
    if str(coordinator).rpartition(":")[0] in _LOOPBACK:
        store = _local_store(coordinator, num_processes, process_id,
                             timeout)
        dist.init_process_group(backend, store=store,
                                world_size=num_processes, rank=process_id,
                                timeout=delta)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=delta)


def state_fingerprint(named):
    """The xsf32-v1 fingerprint of ``{name: NDArray, tensor or array}``, as
    ``mxnet_tpu``'s ``KVStore.state_fingerprint`` computes it: the host
    fold of :mod:`..resilience.integrity`."""
    from ..resilience import integrity

    items = named.items() if hasattr(named, "items") else named
    return integrity.fold_host(
        [(k, v.asnumpy() if isinstance(v, NDArray) else v)
         for k, v in items])


class KVStoreDist(KVStore):
    """The synchronous all-reduce store (``dist`` / ``dist_sync`` /
    ``dist_device_sync``), one process a worker."""

    def __init__(self, kind="dist_sync"):
        super().__init__(kind)
        init_distributed()
        if self.num_workers > 1:
            _watchdog.join_job(self.num_workers, self.rank)

    @property
    def rank(self):
        import torch.distributed as dist

        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def num_workers(self):
        import torch.distributed as dist

        return dist.get_world_size() if dist.is_initialized() else 1

    @property
    def backend(self):
        import torch.distributed as dist

        return dist.get_backend() if dist.is_initialized() else None

    def init(self, key, value):
        """Every worker stores rank 0's value (MXNet's "worker 0
        initializes the server", kvstore_dist.h)."""
        super().init(key, value)
        if self.num_workers > 1:
            import torch.distributed as dist

            for k in _pairs(key, value)[0]:
                with _watchdog.collective_guard(
                        detail=f"kvstore('dist').init({k!r})"):
                    _watchdog.wait_work(dist.broadcast(
                        self._data[k]._data, src=0, async_op=True),
                        "kvstore('dist').broadcast")

    def push(self, key, value, priority=0):
        """:meth:`KVStore.push`, one liveness consultation for all its
        keys first (a dead peer raises PeerLostError before any
        all-reduce)."""
        if self.num_workers > 1:
            _watchdog.check_peers("kvstore('dist').push")
        super().push(key, value, priority)

    def _global_merge(self, merged):
        """The sum of this worker's merged value over every worker."""
        if self.num_workers > 1:
            self.allreduce(merged._data)
        return merged

    def allreduce(self, t):
        """Sum ``t`` (the same shape on every worker) over the workers, in
        place, under the collective watchdog (``mxnet_tpu/kvstore/dist.py:
        376-383``): a dead peer raises PeerLostError naming it, a wedged
        reduction StallError past the collective deadline."""
        import torch.distributed as dist

        detail = f"kvstore('dist').allreduce{tuple(t.shape)}"
        with _watchdog.collective_guard(detail=detail):
            _faults.maybe_hang("hang_collective")
            _watchdog.wait_work(dist.all_reduce(t, async_op=True), detail)
        return t

    def barrier(self):
        if self.num_workers > 1:
            self.allreduce(torch.zeros(
                1, device="cuda" if self.backend == "nccl" else "cpu"))

    def state_fingerprint(self, named):
        return state_fingerprint(named)

    def fingerprint_agree(self, named):
        """Whether every worker's ``named`` folds to this worker's
        fingerprint: the 32-bit fingerprint as two 16-bit halves, their
        sum and square-sum all-reduced in float64; ``sum(x_i) == n*x`` and
        ``sum(x_i^2) == n*x^2`` hold only when every x_i is x
        (``mxnet_tpu/kvstore/dist.py:465``). A disagreement counts in the
        integrity layer's ``integrity_ckpt_mismatches`` and records a
        ``kv_disagree`` flight event."""
        fp = self.state_fingerprint(named)
        n = self.num_workers
        if n <= 1:
            return True
        from ..resilience import integrity as _integrity

        halves = torch.tensor([fp & 0xFFFF, fp >> 16], dtype=torch.float64)
        vec = torch.cat([halves, halves * halves])
        total = vec.clone()
        if self.backend == "nccl":
            total = total.cuda()
        self.allreduce(total)
        agree = bool(torch.equal(total.cpu(), vec * float(n)))
        if not agree:
            _integrity._STATS["integrity_ckpt_mismatches"] += 1
            _integrity._MET_MISMATCHES.inc(surface="checkpoint")
            _obs_flight.record("integrity", op="kv_disagree",
                               rank=self.rank, fingerprint=fp)
        return agree


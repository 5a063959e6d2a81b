"""Atomic, versioned, reshardable training checkpoints (port of
``mxnet_tpu/resilience/checkpoint.py``, format v2).

The durability contract:

- a checkpoint is either fully present and consistent, or it does not
  exist: payloads are written into a hidden temp directory, fsynced,
  stamped with CRC32s in a manifest written last, and published with one
  directory rename followed by a parent-directory fsync;
- ``restore_latest`` never trusts a checkpoint it cannot verify: a
  missing or unreadable manifest, a size or CRC mismatch of any payload,
  or a parameter state whose integrity fingerprint disagrees with the
  manifest, makes it fall back to the next older checkpoint;
- a restore is bitwise: parameters, aux, optimizer state, the generators'
  states and the AMP loss scaler's state round-trip exactly.

Format v2 is ``mxnet_tpu``'s, so the two packages read each other's
checkpoints::

    ckpt-00000042/
        manifest.json      # step/epoch/scaler + per-array records:
                           #   logical shape, dtype, spec, and per-shard
                           #   file {index, crc32, size}
        arrays/00000-000.bin   # one raw-bytes payload per shard
        trainer.state      # gluon Trainer states (eager trainer only)

Each array is saved at its logical shape (whole, or over several ranks
as the shards of the distributed commit below), and a restore places it
through the restoring trainer's own layout, so a state saved from a
dp x fsdp mesh restores onto one rank and back. Restores write the
trainer's tensors in place, so a captured step stays valid.

``save(async_=True)`` copies the state into pinned host buffers on a
copy stream (the compute stream waits on the copy's event, so no later
step overwrites a tensor before it is read), then a daemon thread
serializes and publishes through the same protocol; the next save or
restore barriers on it. Forking a process that holds a CUDA context is
unsafe, so ``mxnet_tpu``'s ``fork`` writer is not ported (ROADMAP Queue
3). A writer killed mid-flight leaves only temp-dir debris, which the
next manager's GC removes; ``keep_n`` retention never deletes a
checkpoint an active restore or publish holds pinned.

The generators' states are the port's ``torch.Generator`` states (field
``torch_rng``): ``mxnet_tpu``'s JAX key (``rng_key``) cannot cross
(ROADMAP Queue 3).

The save of a ``ShardedTrainer`` over several ranks is a **distributed
commit** (``mxnet_tpu/resilience/checkpoint.py:953-1101``) against the
bound pod (``CheckpointManager(..., pod=PodTopology)``, ``bind_pod``), or
without one against ``PodTopology(world, 1)``, each rank its own host. Every rank
writes only the shards it owns -- the owner of a shard is the lowest
rank holding it, so a replicated array is written once, by host 0 --
into one shared ``.{tag}.tmp.pod`` temp dir, as ``arrays/<i>-h<host>-
<j>.bin`` (``mxnet_tpu``'s v2 shard records), then its commit marker
(``commit/host-<h>.rank-<r>.json``); rank 0 (host 0's lead) merges the
markers into the manifest, stamps it ``pod`` and publishes with the same
one rename, and the other ranks leave when the manifest is visible
(``MXNET_TPU_TORCH_CKPT_COMMIT_TIMEOUT_S``, default 120). A tensor-
parallel shard (the qkv rows of a rank's heads) is no box of the whole
array: those parameters are gathered and written whole by host 0. A
crash between a rank's shards and its marker (``ckpt_partial_pod``)
leaves either a whole checkpoint or temp debris, never a torn manifest;
the debris, and a manifest-absent checkpoint dir, are reclaimed only once
quiet past ``MXNET_TPU_TORCH_CKPT_ORPHAN_GRACE_S`` (another host may
still be writing there). A save over several ranks is synchronous, and
its manifest, as ``mxnet_tpu``'s pod commit's, has no parameter
fingerprint (no rank holds the whole state).
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import threading
import time
import warnings
import zlib

import numpy as _np
import torch

from ..base import MXNetError
from ..observability import flight as _obs_flight
from ..observability import trace as _obs_trace
from . import faults

__all__ = ["CheckpointManager", "CheckpointCorruptError", "atomic_write_bytes",
           "stats", "reset_stats"]

_MANIFEST = "manifest.json"
_PARAMS = "params.npz"      # v1 payload name (recognized by retention)
_TRAINER = "trainer.state"
_ARRAYS_DIR = "arrays"
_COMMIT_DIR = "commit"      # per-rank markers of a pod distributed commit
_FORMAT_VERSION = 2
_BF16 = "bfloat16"

_STATS = {"ckpt_saves": 0, "ckpt_save_failures": 0, "ckpt_restores": 0,
          "ckpt_restore_skipped": 0, "ckpt_pruned": 0,
          "ckpt_prune_deferred": 0, "ckpt_async_saves": 0,
          "ckpt_async_waits": 0, "ckpt_async_failures": 0,
          "ckpt_pod_commits": 0, "ckpt_pod_commit_failures": 0}

_LIVE_MANAGERS = None
_TRACK_LOCK = threading.Lock()


def _barrier_all_at_exit():
    with _TRACK_LOCK:
        live = list(_LIVE_MANAGERS or ())
    for mgr in live:
        try:
            mgr.wait_for_async()
        except Exception:
            pass


def _track_manager(mgr):
    """Process exit barriers on every in-flight async save (a daemon
    writer would otherwise die mid-write and lose the final checkpoint)."""
    global _LIVE_MANAGERS
    with _TRACK_LOCK:
        if _LIVE_MANAGERS is None:
            import atexit
            import weakref

            _LIVE_MANAGERS = weakref.WeakSet()
            atexit.register(_barrier_all_at_exit)
        _LIVE_MANAGERS.add(mgr)


class CheckpointCorruptError(RuntimeError):
    """A specific checkpoint failed integrity verification."""


def stats():
    return dict(_STATS)


def reset_stats():
    for k in _STATS:
        _STATS[k] = 0


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path, data, _fsync=True):
    """Crash-safe byte write: a temp file in the same directory, fsync,
    rename, then the directory fsynced. Every checkpoint payload passes
    through here (and the fault filter: ENOSPC, short and corrupt
    writes)."""
    path = os.fspath(path)
    data = faults.checkpoint_write_filter(path, data)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            if _fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if _fsync:
        _fsync_dir(os.path.dirname(path) or ".")


def _write_payload(path, data):
    """One array payload into a checkpoint's temp dir: written and fsynced
    in place (no rename: the temp dir is published whole, after its
    manifest), through the fault filter. ``data``: bytes or a byte
    memoryview (no copy of the array)."""
    data = faults.checkpoint_write_filter(path, data)
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _env_float(name, default):
    raw = os.environ.get(name, "").strip()
    try:
        return float(raw) if raw else float(default)
    except ValueError:
        return float(default)


def _newest_mtime(path):
    newest = 0.0
    try:
        newest = os.stat(path).st_mtime
    except OSError:
        pass
    for root, _dirs, files in os.walk(path):
        for n in files:
            try:
                newest = max(newest, os.stat(os.path.join(root, n)).st_mtime)
            except OSError:
                pass
    return newest


def _is_sharded_trainer(trainer):
    return trainer is not None and hasattr(trainer, "opt_state") \
        and hasattr(trainer, "_checkpoint_arrays")


def _net_param_map(net):
    """name -> Parameter for a Block, or a plain mapping."""
    if hasattr(net, "_param_objects"):
        return net._param_objects()
    if hasattr(net, "items"):
        return dict(net.items())
    raise TypeError(f"cannot collect parameters from {type(net)}")


# ---------------------------------------------------------- host values

def _np_dtype(s):
    """numpy dtype of the payload bytes of manifest dtype ``s`` (bf16 and
    ``mxnet_tpu``'s void-typed bf16 as uint16)."""
    if s in (_BF16, "<V2", "|V2"):
        return _np.dtype(_np.uint16)
    return _np.dtype(s)


def _as_numpy(v):
    """A tensor (or array) as a host numpy array of its bits' dtype (bf16
    as uint16)."""
    if not isinstance(v, torch.Tensor):
        return _np.asarray(v)
    t = v.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().contiguous().numpy().view(
            _np.uint16)
    return t.cpu().contiguous().numpy()


def _to_tensor(arr, dtype_str):
    """A restored payload array as a CPU tensor of the manifest's dtype."""
    if dtype_str in (_BF16, "<V2", "|V2"):
        return torch.from_numpy(_np.ascontiguousarray(arr).view(
            _np.int16)).view(torch.bfloat16)
    arr = _np.ascontiguousarray(arr)
    if arr.dtype.kind not in "biuf":
        raise CheckpointCorruptError(f"unsupported payload dtype {arr.dtype}")
    return torch.from_numpy(arr)


class _PinnedCopy:
    """An async snapshot: pinned host buffers filled on a copy stream, and
    the event the writer waits on before it reads them."""

    def __init__(self, tensors, pool):
        self.event = None
        self.arrays = []
        dev = [t for t in tensors if t.device.type == "cuda"]
        stream = None
        if dev:
            cur = torch.cuda.current_stream(dev[0].device)
            stream = torch.cuda.Stream(dev[0].device)
            stream.wait_stream(cur)
        for i, t in enumerate(tensors):
            t = t.detach()
            if t.device.type != "cuda":
                self.arrays.append(_as_numpy(t.clone()))
                continue
            buf = pool[i] if i < len(pool) and pool[i].shape == t.shape \
                and pool[i].dtype == t.dtype else None
            if buf is None:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                if i < len(pool):
                    pool[i] = buf
                else:
                    pool.append(buf)
            with torch.cuda.stream(stream):
                buf.copy_(t, non_blocking=True)
                t.record_stream(stream)
            self.arrays.append(buf)
        if stream is not None:
            self.event = torch.cuda.Event()
            self.event.record(stream)
            # no later step may write a tensor the copy has not read yet
            torch.cuda.current_stream(dev[0].device).wait_event(self.event)

    def numpy(self):
        if self.event is not None:
            self.event.synchronize()
        return [a if isinstance(a, _np.ndarray) else _as_numpy(a)
                for a in self.arrays]


class CheckpointManager:
    """Atomic versioned checkpoints with retention, verified restore,
    reshardable state and async publish.

    Parameters
    ----------
    directory : checkpoint root (created at the first save; temp debris of
        dead writers is removed at construction)
    keep_n : keep at most this many published checkpoints (env
        ``MXNET_TPU_TORCH_CKPT_KEEP``, default 5; ``<= 0`` keeps all);
        pinned ones are never pruned
    prefix : the checkpoint directories' name prefix
    pod : a ``parallel.PodTopology``: the hosts the distributed commit of
        a trainer over several ranks writes as (module docstring; None:
        each rank its own host); ``bind_pod`` attaches it later
    """

    def __init__(self, directory, keep_n=None, prefix="ckpt", pod=None):
        self._pod = pod
        self.directory = os.fspath(directory)
        if keep_n is None:
            keep_n = int(os.environ.get("MXNET_TPU_TORCH_CKPT_KEEP", "5"))
        self.keep_n = int(keep_n)
        self.prefix = prefix
        self._async = None
        self._pins = {}
        self._pin_lock = threading.Lock()
        self._pinned_pool = []
        self.last_save = None       # {"step", "stall_s", "bytes", "mode"}
        if os.path.isdir(self.directory):
            try:
                self._gc_debris()
            except OSError:
                pass

    def bind_pod(self, pod):
        """Attach (None: detach) the PodTopology the distributed commit
        writes against; a mesh shrink binds the shrunk, renumbered one.
        Returns self."""
        self._pod = pod
        return self

    # ------------------------------------------------------------- listing
    def _tag(self, step):
        return f"{self.prefix}-{int(step):08d}"

    def list_checkpoints(self):
        """[(step, path)] of published checkpoints, oldest first (not
        verified; see :meth:`latest_valid`)."""
        if not os.path.isdir(self.directory):
            return []
        out = []
        want = self.prefix + "-"
        for name in os.listdir(self.directory):
            if not name.startswith(want):
                continue
            suffix = name[len(want):]
            if not suffix.isdigit():
                continue
            path = os.path.join(self.directory, name)
            if os.path.isdir(path):
                out.append((int(suffix), path))
        return sorted(out)

    def verify(self, path):
        """Load and check one checkpoint; returns its manifest or raises
        :class:`CheckpointCorruptError` with the reason."""
        return self._verify(path)[0]

    def _verify(self, path):
        mpath = os.path.join(path, _MANIFEST)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                f"{path}: unreadable manifest ({e})") from e
        version = manifest.get("format_version")
        if version != _FORMAT_VERSION:
            raise CheckpointCorruptError(
                f"{path}: unsupported format_version {version!r}")
        payloads = {}

        def check_file(fname, meta):
            fpath = os.path.join(path, fname)
            try:
                with open(fpath, "rb") as f:
                    # a writable buffer: restored arrays are views of it
                    data = bytearray(os.fstat(f.fileno()).st_size)
                    f.readinto(data)
            except OSError as e:
                raise CheckpointCorruptError(
                    f"{path}: missing payload {fname} ({e})") from e
            if len(data) != meta["size"]:
                raise CheckpointCorruptError(
                    f"{path}: {fname} truncated "
                    f"({len(data)} != {meta['size']} bytes)")
            if zlib.crc32(data) & 0xFFFFFFFF != meta["crc32"]:
                raise CheckpointCorruptError(
                    f"{path}: {fname} failed CRC32 integrity check")
            payloads[fname] = data

        try:
            for fname, meta in manifest.get("files", {}).items():
                check_file(fname, meta)
            for key, rec in manifest.get("arrays", {}).items():
                itemsize = _np_dtype(rec["dtype"]).itemsize
                for shard in rec["shards"]:
                    extent = 1
                    for a, b in shard["index"]:
                        extent *= max(0, int(b) - int(a))
                    if extent * itemsize != shard["size"]:
                        raise CheckpointCorruptError(
                            f"{path}: array '{key}' shard {shard['file']} "
                            f"covers {extent} x {itemsize}B but records "
                            f"{shard['size']} bytes")
                    check_file(shard["file"], shard)
        except (KeyError, TypeError, ValueError) as e:
            raise CheckpointCorruptError(
                f"{path}: malformed manifest record "
                f"({type(e).__name__}: {e})") from e
        return manifest, payloads

    def latest_valid(self):
        """(step, path, manifest) of the newest checkpoint that verifies,
        or None; corrupt ones are skipped with a warning."""
        self.wait_for_async()
        for step, path in reversed(self.list_checkpoints()):
            try:
                with self._pin(path):
                    return step, path, self.verify(path)
            except CheckpointCorruptError as e:
                self._skipped(path, e)
        return None

    @staticmethod
    def _skipped(path, err):
        _STATS["ckpt_restore_skipped"] += 1
        warnings.warn(f"skipping corrupt checkpoint: {err}")
        _obs_flight.record("ckpt", op="restore_skipped", path=path,
                           reason=str(err))

    @contextlib.contextmanager
    def _pin(self, path):
        """Keep ``path`` out of retention pruning for the block."""
        with self._pin_lock:
            self._pins[path] = self._pins.get(path, 0) + 1
        try:
            yield
        finally:
            with self._pin_lock:
                n = self._pins.get(path, 1) - 1
                if n <= 0:
                    self._pins.pop(path, None)
                else:
                    self._pins[path] = n

    # ---------------------------------------------------------------- save
    def save(self, step, net=None, trainer=None, epoch=None, extra=None,
             async_=False):
        """Write one checkpoint atomically; returns its path.

        Saves, as given: the ``ShardedTrainer``'s parameters, aux and
        optimizer state (or ``net``'s parameters and a gluon ``trainer``'s
        states), the generators' states and the loss scaler's state. On a
        failure the earlier checkpoints are untouched.

        ``async_=True`` returns once the state is queued for copying into
        pinned host memory; the CRCs, writes, fsyncs and the publish run
        on a background thread. The next ``save``/``restore*`` waits for
        it; a failed writer is reported there (a warning and
        ``ckpt_async_failures``). ``last_save`` holds this call's step
        stall (seconds the caller was held) and bytes."""
        if net is None and trainer is None:
            raise ValueError("save() needs a net and/or a trainer")
        t0 = time.perf_counter()
        self.wait_for_async()
        if _is_sharded_trainer(trainer) and trainer._multi:
            if async_:
                raise ValueError(
                    "a distributed commit is synchronous: the "
                    "shard-complete barrier is the save (async_=True is "
                    "unsupported for a trainer over several ranks)")
            return self._save_pod(step, trainer, epoch, extra, t0)
        tag = self._tag(step)
        final = os.path.join(self.directory, tag)
        os.makedirs(self.directory, exist_ok=True)
        self._gc_debris()
        keys, tensors, meta = self._collect(net, trainer)
        manifest = self._manifest(step, epoch, extra, tag, trainer, meta,
                                  net, tensors, keys)
        nbytes = sum(int(t.numel()) * t.element_size() for t in tensors)
        if not async_:
            with _obs_trace.span("ckpt.save", step=int(step), mode="sync"):
                self._write_snapshot(keys, [_as_numpy(t) for t in tensors],
                                     meta, manifest, tag, final)
            _obs_flight.record("ckpt", op="save", step=int(step), tag=tag)
            self.last_save = {"step": int(step), "mode": "sync",
                              "stall_s": time.perf_counter() - t0,
                              "bytes": nbytes}
            return final
        copy = _PinnedCopy(tensors, self._pinned_pool)
        _STATS["ckpt_async_saves"] += 1
        _track_manager(self)
        info = {"tag": tag, "final": final, "error": None, "thread": None}
        thread = threading.Thread(
            target=self._thread_write,
            args=(keys, copy, meta, manifest, tag, final, info),
            name="mxnet-torch-ckpt-writer", daemon=True)
        info["thread"] = thread
        self._async = info
        thread.start()
        _obs_flight.record("ckpt", op="save_async", step=int(step), tag=tag)
        self.last_save = {"step": int(step), "mode": "async",
                          "stall_s": time.perf_counter() - t0,
                          "bytes": nbytes}
        return final

    def _collect(self, net, trainer):
        """(keys, tensors, meta): every array the checkpoint holds, at its
        logical shape, and the non-array payloads."""
        keys, tensors = [], []
        meta = {"kind": "gluon", "trainer_bytes": None, "mesh_axes": None}
        if _is_sharded_trainer(trainer):
            meta["kind"] = "sharded"
            for key, t in trainer._checkpoint_arrays():
                keys.append(key)
                tensors.append(t)
            meta["mesh_axes"] = dict(trainer.mesh.shape)
        else:
            if net is not None:
                for name, p in _net_param_map(net).items():
                    keys.append(f"param:{name}")
                    tensors.append(p.data() if hasattr(p, "data") else p)
            if trainer is not None:
                meta["trainer_bytes"] = trainer.get_states_bytes()
        meta["bf16_keys"] = {k for k, t in zip(keys, tensors)
                             if t.dtype == torch.bfloat16}
        return keys, tensors, meta

    def _manifest(self, step, epoch, extra, tag, trainer, meta, net,
                  tensors, keys):
        from . import integrity as _integrity

        integrity_rec = None
        if _integrity.fingerprint_enabled():
            params = {k[len("param:"):]: t for k, t in zip(keys, tensors)
                      if k.startswith("param:")}
            if params:
                integrity_rec = _integrity.manifest_fingerprint(params)
        return {"format_version": _FORMAT_VERSION, "kind": meta["kind"],
                "step": int(step),
                "epoch": None if epoch is None else int(epoch),
                "tag": tag, "rng_key": None, "torch_rng": _rng_state(),
                "loss_scaler": _scaler_state(trainer),
                "mesh_axes": meta["mesh_axes"], "data_state": None,
                "integrity": integrity_rec, "extra": extra or {}}

    def wait_for_async(self, timeout=None):
        """Barrier on the in-flight async save. True when nothing was
        pending or it published; False (a warning, ``ckpt_async_failures``)
        when the writer failed — its debris is left for the GC."""
        info = self._async
        if info is None:
            return True
        with _obs_trace.span("step.ckpt_stall", tag=info["tag"]):
            thread = info["thread"]
            if thread is not None and thread.is_alive():
                _STATS["ckpt_async_waits"] += 1
                thread.join(timeout)
                if thread.is_alive():
                    raise TimeoutError(
                        f"async checkpoint {info['tag']} still writing after "
                        f"{timeout}s")
        self._async = None
        ok = info.get("error") is None
        _obs_flight.record("ckpt", op="async_published" if ok
                           else "async_failed", tag=info["tag"])
        if not ok:
            _STATS["ckpt_async_failures"] += 1
            warnings.warn(
                f"async checkpoint {info['tag']} failed and was dropped "
                f"({info['error']!r}); previous checkpoints are intact")
        return ok

    def _thread_write(self, keys, copy, meta, manifest, tag, final, info):
        try:
            self._write_snapshot(keys, copy.numpy(), meta, manifest, tag,
                                 final, is_async=True)
        except BaseException as e:  # SimulatedCrash included: debris stays
            info["error"] = e

    def _write_snapshot(self, keys, arrays, meta, manifest, tag, final,
                        is_async=False):
        """Serialize host arrays and publish them atomically."""
        tmpdir = os.path.join(self.directory, f".{tag}.tmp.{os.getpid()}")
        if os.path.isdir(tmpdir):
            shutil.rmtree(tmpdir)
        os.makedirs(os.path.join(tmpdir, _ARRAYS_DIR))
        try:
            files, arrays_meta = {}, {}
            for i, (key, arr) in enumerate(zip(keys, arrays)):
                fname = f"{_ARRAYS_DIR}/{i:05d}-000.bin"
                data = memoryview(_np.ascontiguousarray(arr)).cast("B")
                _write_payload(os.path.join(tmpdir, fname), data)
                arrays_meta[key] = {
                    "shape": [int(d) for d in arr.shape],
                    "dtype": _manifest_dtype(key, arr, meta),
                    "spec": None,
                    "shards": [{"file": fname,
                                "index": [[0, int(d)] for d in arr.shape],
                                "crc32": zlib.crc32(data) & 0xFFFFFFFF,
                                "size": len(data)}]}
            # the payloads' names are durable before the manifest names them
            _fsync_dir(os.path.join(tmpdir, _ARRAYS_DIR))
            if meta["trainer_bytes"] is not None:
                data = meta["trainer_bytes"]
                atomic_write_bytes(os.path.join(tmpdir, _TRAINER), data)
                files[_TRAINER] = {"crc32": zlib.crc32(data) & 0xFFFFFFFF,
                                   "size": len(data)}
            faults.maybe_crash("ckpt_crash_before_manifest")
            if is_async:
                faults.maybe_crash("ckpt_async_crash")
            manifest = dict(manifest, arrays=arrays_meta, files=files)
            atomic_write_bytes(os.path.join(tmpdir, _MANIFEST),
                               json.dumps(manifest, indent=1).encode())
            self._publish(tmpdir, final, tag)
        except faults.SimulatedCrash:
            _STATS["ckpt_save_failures"] += 1
            raise  # the partial temp dir stays, as after a real kill
        except BaseException:
            _STATS["ckpt_save_failures"] += 1
            shutil.rmtree(tmpdir, ignore_errors=True)
            raise
        return final

    # ------------------------------------------------------ pod commit
    def _save_pod(self, step, trainer, epoch, extra, t0):
        """The distributed commit of a trainer over several ranks (module
        docstring); returns the published path on every rank."""
        mesh = trainer.mesh
        pod = self._pod
        if pod is None:
            from ..parallel.mesh import PodTopology

            pod = PodTopology(mesh.size, 1, this_host=mesh.rank)
        tag = self._tag(step)
        final = os.path.join(self.directory, tag)
        tmpdir = os.path.join(self.directory, f".{tag}.tmp.pod")
        commit_dir = os.path.join(tmpdir, _COMMIT_DIR)
        publisher = mesh.rank == 0
        if publisher:
            os.makedirs(self.directory, exist_ok=True)
            self._gc_debris()
            # an earlier attempt's debris of this step must not leak stale
            # markers into this one; the barrier below orders the removal
            # before any rank writes
            shutil.rmtree(tmpdir, ignore_errors=True)
            os.makedirs(os.path.join(tmpdir, _ARRAYS_DIR))
            os.makedirs(commit_dir)
        arrays = trainer._pod_shards()
        trainer._barrier()
        host = pod.host_of(mesh.rank)
        nbytes = 0
        try:
            with _obs_trace.span("ckpt.save_pod", step=int(step),
                                 host=int(host)):
                meta = {}
                for i, (key, shape, dtype, spec, shards) in \
                        enumerate(arrays):
                    recs = []
                    for j, (index, value, owner) in enumerate(shards):
                        if owner != mesh.rank:
                            continue
                        arr = _as_numpy(value)
                        fname = (f"{_ARRAYS_DIR}/{i:05d}-h{host:03d}-"
                                 f"{j:03d}.bin")
                        data = memoryview(_np.ascontiguousarray(arr)).cast(
                            "B")
                        _write_payload(os.path.join(tmpdir, fname), data)
                        nbytes += len(data)
                        recs.append({"file": fname,
                                     "index": [list(ab) for ab in index],
                                     "crc32": zlib.crc32(data) & 0xFFFFFFFF,
                                     "size": len(data)})
                    meta[key] = {"shape": list(shape), "dtype": dtype,
                                 "spec": spec, "shards": recs}
                _fsync_dir(os.path.join(tmpdir, _ARRAYS_DIR))
                # the partial-pod kill lands here: shards durable, marker
                # absent, so the barrier never counts this rank complete
                faults.maybe_crash("ckpt_partial_pod")
                atomic_write_bytes(
                    os.path.join(commit_dir,
                                 f"host-{host:03d}.rank-{mesh.rank:05d}.json"),
                    json.dumps({"host": host, "rank": mesh.rank,
                                "arrays": meta}).encode())
                if publisher:
                    merged = self._await_pod_markers(commit_dir, pod)
                    shutil.rmtree(commit_dir, ignore_errors=True)
                    manifest = self._manifest(
                        step, epoch, extra, tag, trainer,
                        {"kind": "sharded",
                         "mesh_axes": dict(mesh.shape)}, None, [], [])
                    manifest.update(arrays=merged, files={}, pod={
                        "num_hosts": int(pod.num_hosts),
                        "devices_per_host": int(pod.devices_per_host)})
                    atomic_write_bytes(os.path.join(tmpdir, _MANIFEST),
                                       json.dumps(manifest,
                                                  indent=1).encode())
                    self._publish(tmpdir, final, tag)
                    _STATS["ckpt_pod_commits"] += 1
                else:
                    self._await_pod_publish(final)
        except faults.SimulatedCrash:
            _STATS["ckpt_save_failures"] += 1
            _STATS["ckpt_pod_commit_failures"] += 1
            raise   # the shared debris stays, as after a host kill
        except BaseException:
            _STATS["ckpt_save_failures"] += 1
            _STATS["ckpt_pod_commit_failures"] += 1
            raise   # peers may still write there: the GC reclaims it
        _obs_flight.record("ckpt", op="save", step=int(step), tag=tag,
                           pod_hosts=int(pod.num_hosts))
        self.last_save = {"step": int(step), "mode": "pod",
                          "stall_s": time.perf_counter() - t0,
                          "bytes": nbytes}
        return final

    def _publish(self, tmpdir, final, tag):
        """Move a complete temp dir into place, fsync the directory, prune.
        A step saved again has its older copy moved aside first (renamed,
        not deleted), so a kill here leaves it absent but recoverable,
        never destroyed before it is replaced."""
        old = None
        if os.path.isdir(final):
            old = os.path.join(self.directory, f".{tag}.old.{os.getpid()}")
            if os.path.isdir(old):
                shutil.rmtree(old)
            os.replace(final, old)
        with self._pin(final):
            os.replace(tmpdir, final)
            _fsync_dir(self.directory)
            if old is not None:
                shutil.rmtree(old, ignore_errors=True)
            _STATS["ckpt_saves"] += 1
            self._prune()

    def _await_pod_markers(self, commit_dir, pod):
        """Rank 0's shard-complete barrier: every rank's marker
        (``MXNET_TPU_TORCH_CKPT_COMMIT_TIMEOUT_S``, default 120), merged
        into one ``arrays`` section (markers disagreeing on a shape or
        dtype are corruption, not a merge)."""
        timeout = _env_float("MXNET_TPU_TORCH_CKPT_COMMIT_TIMEOUT_S", 120.0)
        deadline = time.monotonic() + timeout
        want = [f"host-{pod.host_of(r):03d}.rank-{r:05d}.json"
                for r in range(pod.total_devices)]
        while True:
            missing = [w for w in want
                       if not os.path.isfile(os.path.join(commit_dir, w))]
            if not missing:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"pod commit barrier timed out after {timeout:g}s "
                    f"waiting for marker(s) {missing}: the manifest is "
                    "not published; earlier checkpoints are intact")
            time.sleep(0.02)
        merged = {}
        for w in want:
            with open(os.path.join(commit_dir, w)) as f:
                marker = json.load(f)
            for key, meta in marker["arrays"].items():
                cur = merged.get(key)
                if cur is None:
                    merged[key] = {"shape": meta["shape"],
                                   "dtype": meta["dtype"],
                                   "spec": meta["spec"],
                                   "shards": list(meta["shards"])}
                elif (cur["shape"] != meta["shape"]
                      or cur["dtype"] != meta["dtype"]):
                    raise CheckpointCorruptError(
                        f"pod commit markers disagree on '{key}': "
                        f"{cur['shape']}/{cur['dtype']} vs "
                        f"{meta['shape']}/{meta['dtype']}")
                else:
                    cur["shards"].extend(meta["shards"])
        for rec in merged.values():
            rec["shards"].sort(key=lambda r: r["file"])
        return merged

    def _await_pod_publish(self, final):
        """A non-publishing rank's side of the commit: wait for rank 0's
        manifest (the same timeout)."""
        timeout = _env_float("MXNET_TPU_TORCH_CKPT_COMMIT_TIMEOUT_S", 120.0)
        deadline = time.monotonic() + timeout
        manifest = os.path.join(final, _MANIFEST)
        while not os.path.isfile(manifest):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"pod commit publish of {final} not visible after "
                    f"{timeout:g}s (host 0 lost mid-commit?)")
            time.sleep(0.02)

    def _gc_debris(self):
        """Remove stale ``.{tag}.tmp.{pid}`` dirs of dead writers; a
        ``.{tag}.old.{pid}`` dir whose step is missing (a kill between
        move-aside and publish) is renamed back. Live pids are left
        alone; a pod commit's ``.{tag}.tmp.pod`` only once quiet past the
        orphan grace."""
        pat = re.compile(
            rf"^\.({re.escape(self.prefix)}-\d+)\.(tmp|old)\.(\d+|pod)$")
        for name in os.listdir(self.directory):
            m = pat.match(name)
            if not m:
                continue
            tag, kind, owner = m.group(1), m.group(2), m.group(3)
            path = os.path.join(self.directory, name)
            if owner == "pod":
                # a shared pod-commit dir has no one owner pid: reaped
                # once every writer has plausibly stopped
                grace = _env_float("MXNET_TPU_TORCH_CKPT_ORPHAN_GRACE_S",
                                   900.0)
                if _newest_mtime(path) + grace < time.time():
                    shutil.rmtree(path, ignore_errors=True)
                continue
            pid = int(owner)
            if pid == os.getpid() or _pid_alive(pid):
                continue
            final = os.path.join(self.directory, tag)
            if kind == "old" and not os.path.isdir(final):
                os.replace(path, final)
            else:
                shutil.rmtree(path, ignore_errors=True)

    def _prune(self):
        if self.keep_n <= 0:
            return
        ckpts = self.list_checkpoints()
        with self._pin_lock:
            pinned = set(self._pins)
        removed = 0
        for _, path in ckpts[:max(0, len(ckpts) - self.keep_n)]:
            if path in pinned:
                continue
            if not os.path.isfile(os.path.join(path, _MANIFEST)) \
                    and not os.path.isfile(os.path.join(path, _PARAMS)):
                grace = _env_float("MXNET_TPU_TORCH_CKPT_ORPHAN_GRACE_S",
                                   900.0)
                if _newest_mtime(path) + grace >= time.time():
                    _STATS["ckpt_prune_deferred"] += 1
                    continue
            shutil.rmtree(path, ignore_errors=True)
            _STATS["ckpt_pruned"] += 1
            removed += 1
        if removed:
            _fsync_dir(self.directory)

    # ------------------------------------------------------------- restore
    def restore_latest(self, net=None, trainer=None):
        """Restore the newest valid checkpoint into ``net``/``trainer``;
        returns its manifest, or None when none is valid. A corrupt one
        (manifest, payload CRC, or integrity fingerprint) is skipped for
        the previous one; nothing is changed before verification."""
        self.wait_for_async()
        if os.path.isdir(self.directory):
            self._gc_debris()
        for _, path in reversed(self.list_checkpoints()):
            with self._pin(path):
                try:
                    manifest, payloads = self._verify(path)
                    return self._apply(manifest, payloads, net, trainer)
                except CheckpointCorruptError as e:
                    self._skipped(path, e)
        return None

    def restore(self, path, net=None, trainer=None):
        """Restore one checkpoint (verified, bitwise, onto the trainer's
        current layout); returns its manifest."""
        self.wait_for_async()
        with self._pin(path):
            manifest, payloads = self._verify(path)
            return self._apply(manifest, payloads, net, trainer)

    def _apply(self, manifest, payloads, net, trainer):
        with _obs_trace.span("ckpt.restore", step=manifest.get("step")):
            entries = self._assemble_arrays(manifest, payloads)
            dev = getattr(trainer, "device", None)
            if dev is not None and torch.device(dev).type == "cuda":
                # on the trainer's card first: the fingerprint check folds
                # there (the kernel), and the placing copies nothing more
                entries = {k: v.to(dev) for k, v in entries.items()}
            rec = manifest.get("integrity")
            if rec:
                from . import integrity as _integrity

                if not _integrity.verify_manifest_fingerprint(
                        rec, {k[len("param:"):]: v for k, v in entries.items()
                              if k.startswith("param:")}):
                    raise CheckpointCorruptError(
                        f"step {manifest.get('step')}: reassembled "
                        "parameter state does not match the manifest "
                        "integrity fingerprint (silent data corruption at "
                        "save time)")
            kind = manifest.get("kind", "gluon")
            if kind == "sharded":
                if not _is_sharded_trainer(trainer):
                    raise ValueError(
                        "sharded checkpoint requires trainer= (a "
                        "ShardedTrainer) to restore")
                trainer._restore_checkpoint_arrays(
                    {k: v for k, v in entries.items()
                     if k.startswith(("param:", "aux:"))},
                    {k[len("opt:"):]: v for k, v in entries.items()
                     if k.startswith("opt:")})
            elif net is not None:
                self._restore_net(net, {k[len("param:"):]: v
                                        for k, v in entries.items()
                                        if k.startswith("param:")})
            if trainer is not None and _TRAINER in payloads:
                trainer.set_states_bytes(payloads[_TRAINER])
            _restore_rng(manifest.get("torch_rng"))
            _restore_scaler(trainer, manifest.get("loss_scaler"))
            _STATS["ckpt_restores"] += 1
        _obs_flight.record("ckpt", op="restore", step=manifest.get("step"),
                           tag=manifest.get("tag"))
        return manifest

    @staticmethod
    def _assemble_arrays(manifest, payloads):
        """Each array at its full logical value (a CPU tensor), from its
        CRC-verified shard payloads: the half of resharding that undoes
        the saved layout."""
        out = {}
        for key, rec in manifest.get("arrays", {}).items():
            dtype = _np_dtype(rec["dtype"])
            shape = tuple(int(d) for d in rec["shape"])
            shards = rec["shards"]
            if len(shards) == 1 and [list(map(int, r)) for r in
                                     shards[0]["index"]] == \
                    [[0, d] for d in shape]:
                # one shard of the whole array: a view of its payload
                out[key] = _to_tensor(_np.frombuffer(
                    payloads[shards[0]["file"]], dtype).reshape(shape),
                    rec["dtype"])
                continue
            arr = _np.empty(shape, dtype)
            covered = 0
            for shard in rec["shards"]:
                idx = tuple(slice(int(a), int(b)) for a, b in shard["index"])
                extent = tuple(int(b) - int(a) for a, b in shard["index"])
                arr[idx] = _np.frombuffer(payloads[shard["file"]],
                                          dtype=dtype).reshape(extent)
                n = 1
                for e in extent:
                    n *= e
                covered += n
            if covered < arr.size:
                raise CheckpointCorruptError(
                    f"array '{key}' shards cover {covered} of {arr.size} "
                    "elements (manifest lost a shard record)")
            out[key] = _to_tensor(arr, rec["dtype"])
        return out

    @staticmethod
    def _restore_net(net, entries):
        params = _net_param_map(net)
        missing = set(params) - set(entries)
        if missing:
            raise CheckpointCorruptError(
                f"checkpoint lacks parameters {sorted(missing)[:5]} "
                "required by the net")
        extra = set(entries) - set(params)
        if extra:
            raise CheckpointCorruptError(
                f"checkpoint parameters {sorted(extra)[:5]} not present in "
                "net")
        for name, value in entries.items():
            params[name].set_data(value)


def _manifest_dtype(key, arr, meta):
    """The manifest dtype of one saved array: numpy's string, or
    ``"bfloat16"`` for a bf16 tensor's uint16 bits."""
    return _BF16 if key in meta["bf16_keys"] else arr.dtype.str


def _rng_state():
    from .. import random as _random

    return {str(dev): g.get_state().numpy().tobytes().hex()
            for dev, g in _random._GENERATORS.items()}


def _restore_rng(state):
    if not state:
        return
    from .. import random as _random

    for dev, hexstate in state.items():
        try:
            g = _random.generator(dev)
        except (RuntimeError, ValueError):
            continue  # a device this process does not have
        g.set_state(torch.frombuffer(bytearray.fromhex(hexstate),
                                     dtype=torch.uint8))


def _scaler_state(trainer):
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return None
    return {"loss_scale": float(scaler.loss_scale),
            "unskipped": int(scaler._unskipped)}


def _restore_scaler(trainer, state):
    if state is None or trainer is None:
        return
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    scaler.loss_scale = state["loss_scale"]
    scaler._unskipped = state["unskipped"]

"""KVStore: parameter aggregation over the devices of one process (port of
``mxnet_tpu/kvstore/kvstore.py:24-330``; parity: include/mxnet/kvstore.h,
src/kvstore/kvstore_local.h, comm.h).

:func:`create` takes 'local' (and its aliases), 'device' and 'tpu' /
'nccl' / 'horovod'. In one process all are the same store: ``push`` of a
list sums it in list order (``((v0 + v1) + v2) + ...``, on the first
value's device) and either applies the updater to the stored value or
stores the sum; ``pull`` writes the stored value into each target in
place. 'tpu' / 'nccl' is a device store here, without ``mxnet_tpu``'s
collective watchdog around its push (one process has no peer to lose;
the dist store's all-reduce runs under it). 'dist', 'dist_sync' and 'dist_device_sync'
are :class:`~mxnet_tpu_torch.kvstore.dist.KVStoreDist`, whose push sums
each merged value over the workers (:meth:`KVStore._global_merge`);
'dist_async' raises. Gradient compression (``kvstore/compression.py``)
raises, naming ROADMAP Queue 1 item 11. Values are NDArrays; the updater
is the optimizer's
:class:`~mxnet_tpu_torch.optimizer.Updater` (``set_optimizer``) or any
``updater(key, value, stored)``.
"""
from __future__ import annotations

from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["KVStore", "KVStoreLocal", "KVStoreDevice", "create",
           "check_name"]

_LOCAL = ("local", "local_update_cpu", "local_allreduce_cpu")
_DEVICE = ("device", "local_allreduce_device", "tpu", "nccl", "horovod")
_DIST = ("dist", "dist_sync", "dist_device_sync")


def check_name(name):
    """Raise for a store name the port does not serve; returns the kind."""
    name = name.lower()
    if name in _LOCAL:
        return "local"
    if name in _DEVICE:
        return "device"
    if name in _DIST:
        return "dist"
    if name.startswith("dist") and "async" in name:
        raise MXNetError(
            f"kvstore {name!r}: the asynchronous parameter server has no "
            "counterpart in the port; use 'dist_sync' (a synchronous "
            "all-reduce)")
    raise MXNetError(f"unknown kvstore type {name!r}")


def create(name="local"):
    """A store by name: 'local', 'device', 'tpu' / 'nccl', 'dist_sync'."""
    kind = check_name(name)
    if kind == "dist":
        from .dist import KVStoreDist

        return KVStoreDist(name.lower())
    return KVStoreLocal(name.lower()) if kind == "local" \
        else KVStoreDevice(name.lower())


def _pairs(key, value):
    if isinstance(key, (str, int)):
        return [key], [value]
    if value is None:
        return list(key), [None] * len(key)
    return list(key), list(value)


def _key_int(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


class KVStore:
    """A synchronous store of one process (kvstore.h:59)."""

    def __init__(self, kind):
        self._kind = kind
        self._data = {}
        self._updater = None
        self._optimizer = None

    @property
    def type(self):
        return self._kind

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        """Store a copy of ``value`` (its first entry for a list) under
        ``key`` (a key or a list of keys)."""
        keys, values = _pairs(key, value)
        for k, v in zip(keys, values):
            v0 = v[0] if isinstance(v, (list, tuple)) else v
            self._data[k] = v0.copy()

    def broadcast(self, key, value, out=None):
        self.init(key, value)
        if out is not None:
            self.pull(key, out)

    def _reduce(self, values):
        """The sum of ``values`` in list order, on the first one's
        device."""
        acc = values[0]._data.detach().clone()
        for v in values[1:]:
            acc.add_(v._data.detach().to(acc.device))
        return NDArray(acc, values[0].context)

    def _global_merge(self, merged):
        """The merged value across processes: this one's, in one process
        (``KVStoreDist`` all-reduces it)."""
        return merged

    def push(self, key, value, priority=0):
        """Sum each key's values; apply the updater to the stored value,
        or store the sum when there is none (kvstore_local.h PushImpl)."""
        keys, values = _pairs(key, value)
        for k, v in zip(keys, values):
            merged = self._global_merge(self._reduce(
                list(v) if isinstance(v, (list, tuple)) else [v]))
            if k not in self._data:
                self._data[k] = merged
            elif self._updater is not None:
                stored = self._data[k]
                merged = NDArray(merged._data.to(stored._data.device),
                                 stored.context)
                self._updater(_key_int(k), merged, stored)
            else:
                self._data[k]._set_data(merged._data)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Write each key's stored value into ``out`` (an array or a list
        of them) in place."""
        keys, outs = _pairs(key, out)
        for k, o in zip(keys, outs):
            if k not in self._data:
                raise MXNetError(f"key {k} was not initialized")
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                t._set_data(self._data[k]._data.to(t._data.device))

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise MXNetError("row_sparse_pull needs the row-sparse arrays of "
                         "ROADMAP Queue 1 item 9, which are not ported")

    def excise_dead_peers(self, ranks=None):
        """Clear the watchdog's dead-peer bookkeeping so the store serves
        again after dead ranks left the job (the serving fleet's
        supervisor calls it per re-admitted replica). ``ranks=None`` clears
        every dead rank; an iterable clears only those (one recovered
        replica must not re-admit a peer that is still dead). Returns the
        ranks cleared."""
        from ..resilience import watchdog as _watchdog

        dead = _watchdog.dead_peers()
        if ranks is None:
            cleared = dead
        else:
            wanted = {int(r) for r in ranks}
            cleared = [r for r in dead if r in wanted]
        _watchdog.reset_peers(cleared if ranks is not None else None)
        return cleared

    def set_gradient_compression(self, compression_params):
        raise MXNetError("gradient compression (kvstore/compression.py) is "
                         "ROADMAP Queue 1 item 11, not ported")

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` on the store: a push updates the stored
        weight."""
        from ..optimizer import get_updater

        self._optimizer = optimizer
        self._updater = get_updater(optimizer)

    def set_updater(self, updater):
        self._updater = updater

    def barrier(self):
        pass

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no updater is set")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no updater is set")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())


class KVStoreLocal(KVStore):
    """The 'local' store (kvstore_local.h)."""


class KVStoreDevice(KVStoreLocal):
    """The 'device' store (CommDevice, comm.h:451): the sum runs on the
    first value's device, as every store's does here."""

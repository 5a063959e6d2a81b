"""Silent-data-corruption defense (port of
``mxnet_tpu/resilience/integrity.py``): fingerprints, audits, quarantine,
preemption.

1. **Step fingerprints** — the ``xsf32-v1`` fold: per leaf, the wrapping
   sum and wrapping square-sum of its raw bits as uint32 words, xor-mixed,
   combined over sorted names (``acc * 1000003 + digest + crc32(name)``).
   The same logical values give the same 32-bit value on any layout, eager
   or captured, and on the host (:func:`fold_host`, numpy) bit for bit.
   On the card :func:`fold_tree` is one hand-written CUDA kernel
   (``csrc/state_fold.cu``) that writes one uint32 on the device, with no
   host sync, so it is captured into the step as one more output; on a
   CPU tensor it takes its plain version :func:`fold_plain`. Over several
   ranks (:func:`fold_sharded`) the fold splits: each rank's per-leaf
   sums (``state_fold_sums``; :func:`sums_plain`) of the shards it counts,
   an all-reduce, then the chain (``state_fold_chain``;
   :func:`chain_plain`): bit for bit :func:`fold_host` of the gathered
   state, on every rank.
2. **Shadow replay audit** — on a cadence
   (``MXNET_TPU_TORCH_INTEGRITY_AUDIT_EVERY``) the trainer's pre-step
   state is kept (a device copy) and the step is run again from it and
   the two fingerprints compared. One card has no rotated mesh: the
   replay runs on the same device (ROADMAP Queue 3), which catches a
   transient corruption, not a sticky one. A mismatch runs the
   known-answer self-test (:func:`device_selftest`): a device that fails
   it is quarantined and the step raises ``watchdog.PeerLostError``
   (over several ranks naming the failed ranks, which a trainer with a
   checkpoint manager excises by a mesh shrink); if it passes, the
   corruption was transient — the state rolls back to the snapshot and
   the step runs again.
3. **Boundary checks** — checkpoint manifests carry the parameter-state
   fingerprint and a restore verifies it before it changes the trainer
   (:mod:`checkpoint`); serving replicas are audited with golden queries
   (:func:`audit_serving`).

Preemption: SIGTERM (:func:`install_preempt_handler`) or the ``preempt``
fault makes the next step finish, write an emergency checkpoint and raise
:class:`Preempted` (exit code 0).

Fingerprinting is off by default; ``MXNET_TPU_TORCH_INTEGRITY_FINGERPRINT=1``
arms it, and so does an audit cadence.
"""
from __future__ import annotations

import os
import signal
import threading
import zlib

import numpy as np
import torch

from ..base import MXNetError
from ..observability import flight as _obs_flight
from ..observability import metrics as _obs_metrics

__all__ = [
    "ALGO", "fingerprint_enabled", "audit_every", "audit_due",
    "fold_host", "fold_plain", "fold_tree", "as_uint32", "step_fold",
    "sums_plain", "chain_plain", "fold_sums", "fold_chain", "fold_sharded",
    "step_fold_host",
    "net_named_state", "note_fingerprint_step", "state_fingerprint",
    "manifest_fingerprint", "verify_manifest_fingerprint",
    "snapshot_step", "audit_step", "device_selftest", "quarantine_device",
    "quarantined_devices", "clear_quarantine", "audit_serving",
    "Preempted", "request_preempt", "preempt_requested", "clear_preempt",
    "install_preempt_handler", "preempt_exit", "stats", "reset_stats",
    "reset_state"]

ALGO = "xsf32-v1"

_FOLD_SEED = 2166136261
_FOLD_MUL = 1000003
_DIGEST_MUL = 2654435761
_MASK = 0xFFFFFFFF

_STATS = {
    "integrity_fingerprint_steps": 0,
    "integrity_audits": 0,
    "integrity_audit_skipped": 0,
    "integrity_audit_mismatches": 0,
    "integrity_selftests": 0,
    "integrity_selftest_failures": 0,
    "integrity_quarantined": 0,
    "integrity_rollbacks": 0,
    "integrity_unattributed": 0,
    "integrity_ckpt_fingerprints": 0,
    "integrity_ckpt_verified": 0,
    "integrity_ckpt_mismatches": 0,
    "integrity_serving_audits": 0,
    "integrity_serving_failures": 0,
    "integrity_preempt_requests": 0,
    "integrity_preempt_exits": 0,
}

_MET_AUDITS = _obs_metrics.counter(
    "mxnet_tpu_integrity_audits",
    "shadow replay audits completed (training steps re-executed and "
    "fingerprint-compared)")
_MET_MISMATCHES = _obs_metrics.counter(
    "mxnet_tpu_integrity_mismatches",
    "fingerprint mismatches detected, across audit/checkpoint/serving "
    "surfaces", labels=("surface",))
_MET_QUARANTINED = _obs_metrics.gauge(
    "mxnet_tpu_integrity_quarantined",
    "devices currently in the sticky SDC quarantine set")


def stats():
    return dict(_STATS)


def reset_stats():
    for k in _STATS:
        _STATS[k] = 0


# -------------------------------------------------------------------- knobs

def fingerprint_enabled():
    """Is the step fingerprint armed?
    (``MXNET_TPU_TORCH_INTEGRITY_FINGERPRINT``; on whenever an audit
    cadence is set.)"""
    v = os.environ.get("MXNET_TPU_TORCH_INTEGRITY_FINGERPRINT")
    if v is not None:
        return v.strip().lower() not in ("", "0", "false", "off")
    return audit_every() > 0


def audit_every():
    """Shadow-replay cadence in steps
    (``MXNET_TPU_TORCH_INTEGRITY_AUDIT_EVERY``; 0 = off)."""
    try:
        return int(os.environ.get("MXNET_TPU_TORCH_INTEGRITY_AUDIT_EVERY",
                                  "0"))
    except ValueError:
        return 0


def audit_due(step_no):
    every = audit_every()
    return every > 0 and int(step_no) % every == 0


def _selftest_rounds():
    try:
        return max(1, int(os.environ.get(
            "MXNET_TPU_TORCH_INTEGRITY_SELFTEST_N", "3")))
    except ValueError:
        return 3


# ------------------------------------------------------------- xsf32-v1 fold

def _sorted_named(named):
    items = named.items() if hasattr(named, "items") else named
    return sorted((str(k), v) for k, v in items)


def _crc(name):
    return zlib.crc32(name.encode("utf-8")) & _MASK


def _np_words(arr):
    """Host path: the leaf's raw bits as a flat uint32 array (a torch
    tensor is read through its bits, bf16 included)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bool:
            return t.numpy().astype(np.uint32).ravel()
        if t.element_size() == 2:
            t = t.view(torch.int16)   # bf16 has no numpy dtype
        arr = t.numpy()
    a = np.asarray(arr)
    if a.dtype == np.bool_:
        return a.astype(np.uint32).ravel()
    flat = np.ascontiguousarray(a).ravel()
    size = flat.dtype.itemsize
    if size == 4:
        return flat.view(np.uint32)
    if size == 2:
        return flat.view(np.uint16).astype(np.uint32)
    if size == 1:
        return flat.view(np.uint8).astype(np.uint32)
    if size == 8:
        return flat.view(np.uint32)  # two words per element
    raise TypeError(f"xsf32-v1 cannot fold dtype {a.dtype}")


def _digest_host(arr):
    words = _np_words(arr)
    if words.size == 0:
        return 0
    s1 = int(np.sum(words, dtype=np.uint32))
    s2 = int(np.sum(words * words, dtype=np.uint32))
    return (s1 ^ ((s2 * _DIGEST_MUL) & _MASK)) & _MASK


def fold_host(named):
    """Fingerprint of ``{name: array or tensor}`` computed on the host
    (numpy); bit-identical to :func:`fold_tree` of the same values."""
    acc = _FOLD_SEED
    for name, arr in _sorted_named(named):
        acc = (acc * _FOLD_MUL + _digest_host(arr) + _crc(name)) & _MASK
    return acc


_WORD_VIEWS = {4: (torch.int32, _MASK), 2: (torch.int16, 0xFFFF),
               1: (torch.uint8, 0xFF)}


def _words64(t):
    """A tensor's elements' bits zero-extended, as int64 (the plain
    version's only way to a wrapping uint32 sum). 8-byte elements raise,
    as they do in ``mxnet_tpu``'s traced fold."""
    if t.dtype == torch.bool:
        return t.reshape(-1).to(torch.int64)
    size = t.element_size()
    if size not in _WORD_VIEWS:
        raise TypeError(f"xsf32-v1 cannot fold dtype {t.dtype} in-graph")
    view, mask = _WORD_VIEWS[size]
    return t.contiguous().reshape(-1).view(view).to(torch.int64) & mask


def _sums_one(t):
    """(s1, s2) of one leaf as 0-d int64 tensors on its device, each mod
    2^32. The square is taken mod 2^32 from 16-bit halves: a 32-bit
    word's square overflows a signed int64."""
    w = _words64(t)
    if w.numel() == 0:
        zero = torch.zeros((), dtype=torch.int64, device=t.device)
        return zero, zero
    lo, hi = w & 0xFFFF, w >> 16
    sq = (lo * lo + (((2 * hi * lo) & 0xFFFF) << 16)) & _MASK
    return w.sum() & _MASK, sq.sum() & _MASK


def sums_plain(named, counted=None):
    """The plain version of the ``state_fold_sums`` kernel: an (n, 2) int64
    tensor of each leaf's wrapping uint32 sum and square-sum, in sorted-name
    order; a leaf whose ``counted`` entry (by name; default: all counted)
    is false sums to (0, 0)."""
    items = _sorted_named(named)
    dev = items[0][1].device if items else torch.device("cpu")
    rows = []
    for name, t in items:
        if counted is None or counted.get(name, True):
            rows.append(torch.stack(_sums_one(t)))
        else:
            rows.append(torch.zeros(2, dtype=torch.int64, device=dev))
    if not rows:
        return torch.zeros((0, 2), dtype=torch.int64, device=dev)
    return torch.stack(rows)


def chain_plain(sums, crcs):
    """The plain version of the ``state_fold_chain`` kernel: the
    fingerprint (a 0-d int32 holding the uint32's bits) from (n, 2) sums
    (their low 32 bits) and the names' crc32s (ints), in order:
    ``acc = acc * 1000003 + (s1 ^ s2 * 2654435761) + crc``."""
    s = sums.to(torch.int64) & _MASK
    digests = torch.bitwise_xor(s[:, 0], (s[:, 1] * _DIGEST_MUL) & _MASK)
    # the crc32s stay host ints and the seed a fill: no host-to-device
    # copy, so a CUDA graph can hold the plain fold
    acc = torch.full((), _FOLD_SEED, dtype=torch.int64, device=s.device)
    for i, crc in enumerate(crcs):
        acc = (acc * _FOLD_MUL + digests[i] + int(crc)) & _MASK
    return (acc - ((acc >> 31) << 32)).to(torch.int32)


def fold_plain(named):
    """The plain PyTorch version of the fold kernel: the fingerprint of
    ``{name: tensor}`` as a 0-d int32 tensor holding the uint32's bits, on
    the leaves' device (the CPU tests, and phase b on the card):
    :func:`chain_plain` of :func:`sums_plain`."""
    items = _sorted_named(named)
    return chain_plain(sums_plain(items), [_crc(n) for n, _ in items])


# blocks a leaf's run may take: one per 64 KB, at most 4096
_BLOCK_BYTES = 1 << 16
_MAX_BLOCKS = 4096
_TABLES: dict = {}          # signature -> _Table (captured ones kept)
_SPARES: dict = {}          # layout -> a device table for the next capture
_TABLES_EAGER_CAP = 8


class _Table:
    """The device table, scratch and pinned source of one signature."""

    __slots__ = ("host", "dev", "partials", "digests", "n", "blocks",
                 "pinned")


def _table_for(items, device, counted=None):
    """The cached :class:`_Table` of ``items`` ([(name, tensor)] sorted):
    rows of (pointer, elements, element size, crc32, first block, block
    count); a leaf whose ``counted`` flag (a tuple in order) is false is a
    row of 0 elements. Outside a capture the rows go to the device by one
    asynchronous copy from pinned memory, and a spare device table of the
    same layout is set aside. Inside a ``CapturedExec`` capture (whose
    warm-up runs came first) the spare is taken and its write deferred to
    the capture's end: a capture cannot hold the host-to-device copy of
    its own addresses, and a table allocated in the capture would share
    the graph's memory with temporaries that a replay writes before the
    fold reads it. A table that a capture made or found is never evicted,
    since its graph reads it at every replay."""
    if counted is None:
        counted = (True,) * len(items)
    key = (device,) + tuple((n, t.data_ptr(), t.numel() if c else 0,
                             t.element_size(), t.dtype == torch.bool)
                            for (n, t), c in zip(items, counted))
    tab = _TABLES.get(key)
    if tab is not None:
        # an eager table that a capture reads (leaves at their warm-up
        # addresses) is kept from then on, as a captured one is
        if torch.cuda.is_current_stream_capturing():
            tab.pinned = True
        return tab
    rows, first = [], 0
    for (name, t), c in zip(items, counted):
        esize = 1 if t.dtype == torch.bool else t.element_size()
        if esize not in _WORD_VIEWS:
            raise TypeError(
                f"xsf32-v1 cannot fold dtype {t.dtype} in-graph")
        n = t.numel() if c else 0
        nbytes = n * esize
        blocks = max(1, min(_MAX_BLOCKS, -(-nbytes // _BLOCK_BYTES),
                            nbytes // 16))
        rows.append([t.data_ptr(), n, esize, _crc(name), first, blocks])
        first += blocks
    layout = (device,) + tuple(k[0:1] + k[2:] for k in key[1:])
    capturing = torch.cuda.is_current_stream_capturing()
    tab = _Table()
    tab.host = torch.tensor(rows, dtype=torch.int64)
    tab.partials = torch.empty(2 * first, dtype=torch.int32, device=device)
    tab.digests = torch.empty(len(rows), dtype=torch.int32, device=device)
    tab.n, tab.blocks, tab.pinned = len(rows), first, capturing
    if capturing:
        from .. import capture as _capture

        tab.dev = _SPARES.pop(layout, None)
        if tab.dev is None:
            raise _capture.CaptureError(
                "fold_tree: no table set aside for this state's layout; a "
                "captured fold needs an eager run of it first (CapturedExec "
                "warms up before it captures)")
        _capture.defer_until_captured(lambda: tab.dev.copy_(tab.host))
    else:
        eager = [k for k, v in _TABLES.items() if not v.pinned]
        while len(eager) >= _TABLES_EAGER_CAP:
            _TABLES.pop(eager.pop(0), None)
        tab.dev = torch.empty_like(tab.host, device=device)
        tab.host = tab.host.pin_memory()
        tab.dev.copy_(tab.host, non_blocking=True)
        if layout not in _SPARES:
            _SPARES[layout] = torch.empty_like(tab.dev)
    _TABLES[key] = tab
    return tab


def _fold_lib():
    import ctypes

    from ..ops import _build

    lib = _build.load("state_fold")
    if lib.state_fold.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.state_fold.argtypes = [p, i, ll, p, p, p, p]
        lib.state_fold_sums.argtypes = [p, i, ll, p, p, p]
        lib.state_fold_chain.argtypes = [p, p, i, p, p]
        for fn in (lib.state_fold, lib.state_fold_sums,
                   lib.state_fold_chain):
            fn.restype = ctypes.c_int
        lib.state_fold_error_string.argtypes = [ctypes.c_int]
        lib.state_fold_error_string.restype = ctypes.c_char_p
    return lib


def _check_err(lib, err, entry):
    if err:
        msg = lib.state_fold_error_string(err).decode()
        raise MXNetError(f"{entry} launch failed: {msg} (error {err})")


def _contiguous(items):
    for name, t in items:
        if not t.is_contiguous():
            raise ValueError(f"fold_tree: {name} must be contiguous on CUDA")


def _launch_fold(items, device):
    _contiguous(items)
    lib = _fold_lib()
    out = torch.empty((), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        tab = _table_for(items, device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.state_fold(tab.dev.data_ptr(), tab.n, tab.blocks,
                             tab.partials.data_ptr(), tab.digests.data_ptr(),
                             out.data_ptr(), stream)
    _check_err(lib, err, "state_fold")
    fold_tree.launches += 1
    return out


def fold_tree(named):
    """The fingerprint of ``{name: tensor}`` as a 0-d int32 tensor (the
    uint32's bits) on the leaves' device. CUDA leaves launch
    ``csrc/state_fold.cu`` (two launches, counted once in
    ``fold_tree.launches``) or raise; CPU leaves take :func:`fold_plain`.
    Read the value with :func:`as_uint32`."""
    items = [(n, t.detach()) for n, t in _sorted_named(named)]
    if not items:
        return torch.tensor(_FOLD_SEED - (1 << 32), dtype=torch.int32)
    dev = _one_device(items)
    if dev.type == "cuda":
        return _launch_fold(items, dev)
    return fold_plain(dict(items))


fold_tree.launches = 0


def fold_sums(named, counted=None):
    """Each leaf's wrapping (s1, s2) as an (n, 2) int64 tensor on the
    leaves' device, in sorted-name order, a leaf whose ``counted`` flag
    (``{name: bool}``, default all) is false as (0, 0): the half of the
    fold that adds over shards. CUDA leaves launch ``state_fold_sums`` of
    ``csrc/state_fold.cu`` (counted in ``fold_sums.launches``) or raise;
    CPU leaves take :func:`sums_plain`."""
    items = [(n, t.detach()) for n, t in _sorted_named(named)]
    flags = tuple(bool(counted.get(n, True)) if counted is not None
                  else True for n, _ in items)
    dev = _one_device(items)
    if dev.type == "cpu":
        return sums_plain(dict(items), dict(zip((n for n, _ in items),
                                                flags)))
    _contiguous(items)
    lib = _fold_lib()
    sums = torch.empty((len(items), 2), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        tab = _table_for(items, dev, flags)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.state_fold_sums(tab.dev.data_ptr(), tab.n, tab.blocks,
                                  tab.partials.data_ptr(), sums.data_ptr(),
                                  stream)
    _check_err(lib, err, "state_fold_sums")
    fold_sums.launches += 1
    return sums


fold_sums.launches = 0
_CRCS: dict = {}


def fold_chain(sums, names):
    """The fingerprint (a 0-d int32 holding the uint32's bits) from the
    (n, 2) ``sums`` of the sorted ``names`` (all-reduced over the ranks:
    their low 32 bits count). CUDA sums launch ``state_fold_chain``
    (counted in ``fold_chain.launches``) or raise; CPU sums take
    :func:`chain_plain`."""
    names = tuple(sorted(str(n) for n in names))
    if sums.device.type == "cpu":
        return chain_plain(sums, [_crc(n) for n in names])
    key = (sums.device, names)
    crcs = _CRCS.get(key)
    if crcs is None:
        crcs = _CRCS[key] = torch.tensor([_crc(n) for n in names],
                                         dtype=torch.int64,
                                         device=sums.device)
    sums = sums.contiguous()
    lib = _fold_lib()
    out = torch.empty((), dtype=torch.int32, device=sums.device)
    with torch.cuda.device(sums.device):
        stream = torch.cuda.current_stream(sums.device).cuda_stream
        err = lib.state_fold_chain(sums.data_ptr(), crcs.data_ptr(),
                                   len(names), out.data_ptr(), stream)
    _check_err(lib, err, "state_fold_chain")
    fold_chain.launches += 1
    return out


fold_chain.launches = 0


def _one_device(items):
    devs = {t.device for _, t in items}
    if len(devs) != 1:
        raise ValueError(f"fold: leaves lie on several devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"fold: unsupported device {dev}")
    return dev


def fold_sharded(named, counted, mesh):
    """The fingerprint of a state split over ``mesh``'s ranks, equal on
    every rank to :func:`fold_host` of the gathered state: each rank's
    :func:`fold_sums` of what it holds (``counted[name]``: does this rank
    add that leaf -- one rank per element), the sums all-reduced over
    every rank (int64, then their low 32 bits), then :func:`fold_chain`.
    Zero padding adds nothing to a sum. Every rank calls it."""
    from ..parallel import collectives

    sums = fold_sums(named, counted)
    collectives.all_reduce(sums, mesh, tuple(mesh.axis_names))
    return fold_chain(sums.bitwise_and_(_MASK), list(named))


def as_uint32(fp):
    """The Python int of a fold's output (a 0-d int32 tensor, or an
    int)."""
    if isinstance(fp, torch.Tensor):
        fp = int(fp.item())
    return int(fp) & _MASK


def _step_named(new_params, grads):
    named = {f"param:{k}": v for k, v in new_params.items()}
    named.update({f"grad:{k}": v for k, v in grads.items()})
    return named


def step_fold(new_params, grads):
    """The step fingerprint on the device: post-update params +
    gradients."""
    return fold_tree(_step_named(new_params, grads))


def step_fold_host(new_params, grads):
    """Host twin of :func:`step_fold`."""
    return fold_host(_step_named(new_params, grads))


def net_named_state(net):
    """``(params, grads)`` name -> tensor dicts of a gluon net's current
    values (post-update params, and the gradients of parameters whose
    grad_req is not 'null') — the operand set of the gluon step's
    fingerprint."""
    named_p, named_g = {}, {}
    for name, p in net._param_objects().items():
        try:
            named_p[name] = p.data()
        except Exception:
            continue  # deferred/uninitialized parameter
        if getattr(p, "grad_req", "null") == "null":
            continue
        g = p.data().grad
        if g is not None:
            named_g[name] = g
    return named_p, named_g


def note_fingerprint_step():
    _STATS["integrity_fingerprint_steps"] += 1


def state_fingerprint(params):
    """Fingerprint of a parameter state ``{name: tensor or array}`` alone:
    the value checkpoint manifests record. Tensors fold on their device."""
    named = {f"param:{k}": v for k, v in params.items()}
    if named and all(isinstance(v, torch.Tensor) for v in named.values()) \
            and len({v.device for v in named.values()}) == 1:
        return as_uint32(fold_tree(
            {k: v.contiguous() for k, v in named.items()}))
    return fold_host(named)


def manifest_fingerprint(params):
    fp = state_fingerprint(params)
    _STATS["integrity_ckpt_fingerprints"] += 1
    return {"algo": ALGO, "params": int(fp)}


def verify_manifest_fingerprint(record, params):
    """Does a restore's reassembled parameter state match the manifest's
    fingerprint? Records with an unknown algo (or none) verify trivially.
    A mismatch is counted and flight-recorded; the caller raises."""
    if not record or record.get("algo") != ALGO \
            or record.get("params") is None:
        return True
    got = int(state_fingerprint(params))
    if got == int(record["params"]):
        _STATS["integrity_ckpt_verified"] += 1
        return True
    _STATS["integrity_ckpt_mismatches"] += 1
    _MET_MISMATCHES.inc(surface="checkpoint")
    _obs_flight.record("integrity", op="ckpt_mismatch",
                       want=int(record["params"]), got=got)
    return False


# --------------------------------------------------------------- quarantine

_QUARANTINE_LOCK = threading.Lock()
_QUARANTINE: set = set()


def quarantine_device(device_id, reason="selftest_failed"):
    device_id = int(device_id)
    with _QUARANTINE_LOCK:
        new = device_id not in _QUARANTINE
        if new:
            _QUARANTINE.add(device_id)
            _STATS["integrity_quarantined"] += 1
            _MET_QUARANTINED.set(len(_QUARANTINE))
    if new:
        _obs_flight.record("integrity", op="quarantine",
                           device=device_id, reason=reason)


def quarantined_devices():
    with _QUARANTINE_LOCK:
        return sorted(_QUARANTINE)


def clear_quarantine():
    with _QUARANTINE_LOCK:
        _QUARANTINE.clear()
        _MET_QUARANTINED.set(0)


# ---------------------------------------------------------------- self-test

def _device_id(device):
    device = torch.device(device)
    return 0 if device.index is None else int(device.index)


def device_selftest(device, rounds=None, ident=None):
    """Known-answer battery for one device: 64x64 integer matrix products
    (entries within +-125, so every partial sum is an integer below 2^24)
    computed on the device in float64 and compared with the exact int64
    product from the host. There is one right answer, so any deviation is
    hardware corruption. ``sdc_device_sticky`` corrupts the victim's
    result here (``ident``: the id the fault's victim is named by; by
    default the device's index; a multi-rank trainer passes its rank)."""
    from . import faults as _faults

    _STATS["integrity_selftests"] += 1
    rounds = _selftest_rounds() if rounds is None else int(rounds)
    device = torch.device(device)
    n = 64
    ok = True
    for i in range(rounds):
        a = ((np.arange(n * n, dtype=np.int64) * (3 * i + 7)) % 251
             - 125).reshape(n, n)
        b = ((np.arange(n * n, dtype=np.int64)[::-1] * (5 * i + 11)) % 241
             - 120).reshape(n, n)
        want = a @ b
        got = torch.matmul(torch.as_tensor(a, dtype=torch.float64,
                                           device=device),
                           torch.as_tensor(b, dtype=torch.float64,
                                           device=device))
        got = got.cpu().numpy().astype(np.int64)
        got = _faults.maybe_sdc_selftest(
            got, _device_id(device) if ident is None else int(ident))
        if not np.array_equal(got, want):
            ok = False
            break
    if not ok:
        _STATS["integrity_selftest_failures"] += 1
        _obs_flight.record("integrity", op="selftest_failed",
                           device=_device_id(device))
    return ok


# ------------------------------------------------- shadow replay audit core

def snapshot_step(trainer):
    """The pre-step state of ``trainer`` (a ShardedTrainer whose step
    counter has just advanced) when an audit is due, else None: device
    copies of every state tensor the step updates in place (over several
    ranks, each rank's own)."""
    if not audit_due(getattr(trainer, "_step_count", 0)):
        return None
    return {"step": int(trainer._step_count),
            "state": [t.detach().clone() for t in trainer._state_tensors()],
            "retries": 0}


def _restore_snapshot(trainer, snap):
    with torch.no_grad():
        for t, s in zip(trainer._state_tensors(), snap["state"]):
            t.copy_(s)


def _state_fp(trainer):
    """The parameter-state fingerprint of ``trainer`` (over several ranks,
    the gathered state's, the same on every rank)."""
    fn = getattr(trainer, "_state_fingerprint", None)
    return fn() if fn is not None else state_fingerprint(trainer.params)


def audit_step(trainer, snap, run_step, live_fp=None):
    """The shadow replay audit: put the snapshot back, run the step again
    (``run_step()`` returns its fingerprint output or None) on the same
    device, and compare the state and step fingerprints with the live
    run's. Returns None (clean, or no snapshot) or ``"retry"`` after a
    transient-corruption rollback (the caller runs the step again); raises
    ``watchdog.PeerLostError`` naming the rank(s) whose device failed the
    self-test. On a clean audit the trainer holds the replay's state,
    bitwise the live one. Over several ranks every rank replays and
    compares the global fingerprints, so all reach the same verdict, and
    the self-test verdicts are all-reduced: every rank names the same
    failed ranks, which the trainer's recovery excises."""
    if snap is None:
        return None
    from . import watchdog as _watchdog

    _STATS["integrity_audits"] += 1
    _MET_AUDITS.inc()
    live_state = _state_fp(trainer)
    _restore_snapshot(trainer, snap)
    replay_fp = run_step()
    shadow_state = _state_fp(trainer)
    ok = live_state == shadow_state
    if ok and live_fp is not None and replay_fp is not None:
        ok = as_uint32(live_fp) == as_uint32(replay_fp)
    step_no = int(getattr(trainer, "_step_count", snap["step"]))
    _obs_flight.record("integrity", op="audit", step=step_no, match=bool(ok))
    if ok:
        return None
    _STATS["integrity_audit_mismatches"] += 1
    _MET_MISMATCHES.inc(surface="train")
    _obs_flight.record("integrity", op="mismatch", step=step_no,
                       live=live_state, shadow=shadow_state)
    multi = getattr(trainer, "_multi", False)
    rank = trainer._fault_id() if multi else None
    passed = device_selftest(trainer.device, ident=rank)
    failed = trainer._failed_ranks(passed) if multi else \
        ([] if passed else [0])
    if failed:
        for r in failed:
            _watchdog.mark_peer_dead(r)
        if not passed:
            quarantine_device(_device_id(trainer.device) if rank is None
                              else rank)
        who = (f"device {_device_id(trainer.device)}" if not multi
               else f"rank(s) {failed}")
        err = _watchdog.PeerLostError(
            f"integrity audit at step {step_no}: {who} failed the "
            "known-answer self-test and is quarantined")
        err.ranks = tuple(failed)
        err.hosts = tuple(trainer._hosts_of(failed)) if multi else ()
        raise err
    snap["retries"] += 1
    if snap["retries"] > 2:
        _STATS["integrity_unattributed"] += 1
        _obs_flight.record("integrity", op="unattributed", step=step_no)
        return None
    _restore_snapshot(trainer, snap)
    _STATS["integrity_rollbacks"] += 1
    _obs_flight.record("integrity", op="rollback", step=step_no)
    return "retry"


# ------------------------------------------------------------ serving audit

def audit_serving(fleet, feeds, golden, model="default", timeout=10.0):
    """Golden-query audit: submit ``feeds`` to every HEALTHY replica
    directly and compare with ``golden`` (expected output arrays) bitwise;
    a lying replica goes through ``fleet.fail_replica(reason=
    "integrity_audit")``. Returns the failed replica ids."""
    _STATS["integrity_serving_audits"] += 1
    golden = [np.asarray(v) for v in golden]
    failed = []
    for replica in list(fleet.replicas(model)):
        if getattr(replica, "state", None) != "HEALTHY":
            continue
        rid = int(replica.rid)
        try:
            out = replica.submit(feeds).result(timeout=timeout)
        except Exception:
            continue  # loud failures are the probe loop's to handle
        out = [v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
               else np.asarray(v) for v in out]
        clean = (len(out) == len(golden)
                 and all(np.array_equal(a, b) for a, b in zip(out, golden)))
        if clean:
            continue
        failed.append(rid)
        _STATS["integrity_serving_failures"] += 1
        _MET_MISMATCHES.inc(surface="serving")
        _obs_flight.record("integrity", op="serving_mismatch", model=model,
                           replica=rid)
        fleet.fail_replica(rid=rid, model=model, reason="integrity_audit")
    return failed


# --------------------------------------------------------- preemption grace

class Preempted(SystemExit):
    """Clean preemption exit (code 0): the in-flight step finished and the
    emergency checkpoint was published."""

    def __init__(self, step, manifest=None):
        super().__init__(0)
        self.step = int(step)
        self.manifest = manifest


_PREEMPT = threading.Event()
_PREV_SIGTERM = None
_HANDLER_LOCK = threading.Lock()
_HANDLER_INSTALLED = False


def request_preempt(reason="sigterm"):
    if not _PREEMPT.is_set():
        _STATS["integrity_preempt_requests"] += 1
        _obs_flight.record("integrity", op="preempt_requested",
                           reason=reason)
    _PREEMPT.set()


def preempt_requested():
    return _PREEMPT.is_set()


def clear_preempt():
    _PREEMPT.clear()


def install_preempt_handler():
    """Trap SIGTERM so preemption drains instead of killing mid-step
    (``MXNET_TPU_TORCH_PREEMPT_SIGTERM``, default on). Idempotent; chains
    a previously installed handler; skipped off the main thread."""
    global _PREV_SIGTERM, _HANDLER_INSTALLED

    if os.environ.get("MXNET_TPU_TORCH_PREEMPT_SIGTERM", "1").strip() \
            .lower() in ("0", "false", "off"):
        return False
    with _HANDLER_LOCK:
        if _HANDLER_INSTALLED:
            return True

        def _on_sigterm(signum, frame):
            request_preempt(reason="sigterm")
            prev = _PREV_SIGTERM
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, frame)

        try:
            _PREV_SIGTERM = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:  # not the main thread
            return False
        _HANDLER_INSTALLED = True
        return True


def preempt_exit(trainer, loss=None):
    """Finish preemption at a step boundary: an emergency checkpoint
    (published before the raise) through the trainer's manager, then
    :class:`Preempted`."""
    step = int(getattr(trainer, "_step_count", 0))
    manifest = None
    mgr = getattr(trainer, "_ckpt_mgr", None)
    if mgr is not None:
        manifest = mgr.save(step, trainer=trainer, async_=True)
        mgr.wait_for_async()
    _STATS["integrity_preempt_exits"] += 1
    _obs_flight.record("integrity", op="preempt_exit", step=step,
                       checkpointed=mgr is not None)
    clear_preempt()
    raise Preempted(step, manifest)


def reset_state():
    """Forget quarantine and preemption bookkeeping (tests, drills)."""
    clear_quarantine()
    clear_preempt()

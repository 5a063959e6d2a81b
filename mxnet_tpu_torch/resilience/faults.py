"""Deterministic fault injection (port of ``mxnet_tpu/resilience/faults.py``,
the serving kinds).

Every guarded operation of the serving runtime calls a cheap hook here
(``maybe_*``) that does nothing unless its fault is armed. Faults are armed
in code (:func:`inject` / :func:`arm`) or from ``MXNET_TPU_TORCH_FAULTS``, a
comma list of ``kind[@at_step[:times]]`` (``*`` for unlimited), e.g.::

    MXNET_TPU_TORCH_FAULTS="replica_crash@2,replica_nan_storm@0:4"

``arm(kind, at_step=k, times=n)`` fires on the k-th .. (k+n-1)-th call of
the hook (0-based; ``times=None`` = every call from k on).

The serving kinds and their hooks:

- ``nan_serving`` — one inference batch poisoned with NaN
  (``serving.Predictor.predict_raw``; the BatchServer sentinel fails it);
- ``hang_batch`` — a BatchServer batch wedged in an interruptible sleep
  until the batch watchdog fires;
- ``replica_crash`` / ``replica_hang`` / ``replica_nan_storm`` /
  ``sdc_serving`` — one fleet replica (``MXNET_TPU_TORCH_FAULT_REPLICA``,
  default 0) crashes mid-batch (a process replica exits), hangs, poisons
  its batches, or flips one low bit of its outputs;
- ``slo_burn`` — the fleet SLO counters the gauges and the burn-rate
  rules read are inflated by ``MXNET_TPU_TORCH_FAULT_SLO_BURN_N`` (64)
  deadline misses;
- ``rollout_bad_weights`` / ``canary_slo_regression`` — a rollout's
  candidate weights poisoned with NaN, or its canary latencies inflated
  ``MXNET_TPU_TORCH_FAULT_CANARY_SLO_X`` (10) times;
- ``autoscale_flap`` — the autoscaler's queue signal swings between
  ``MXNET_TPU_TORCH_FAULT_FLAP_QUEUE`` (1e6) and 0 at every evaluation;
- ``decode_replica_death`` — a decode engine dies between token steps;
- ``kv_pool_exhaustion`` — the KV page pool reports no free page;
- ``int8_calib_mismatch`` — a stale CalibrationTable clone swapped in at
  quantize time, which validation must refuse.

The training kinds and their hooks:

- ``nan_grad`` / ``nonfinite_grad`` — one gradient poisoned with NaN
  (gluon ``Trainer.step``/``update``; ``nonfinite_grad`` picks the layer
  ``MXNET_TPU_TORCH_FAULT_NONFINITE_LAYER`` names, by default the middle
  parameter). A captured gluon step poisons the batch (``nan_grad``) or
  the layer's weight (``nonfinite_grad``) instead, so the NaN flows
  through the real graph;
- ``ckpt_enospc`` / ``ckpt_partial_write`` / ``ckpt_shard_corrupt`` — a
  checkpoint byte write raises ENOSPC, is cut short, or has one byte of an
  array payload flipped (:func:`checkpoint_write_filter`);
- ``ckpt_crash_before_manifest`` / ``ckpt_async_crash`` — a simulated
  death between the payloads and the manifest, or of the background
  writer before it publishes (:func:`maybe_crash`);
- ``hang_step`` — the training step wedged until the step watchdog fires;
- ``oom_step`` — an injected out-of-memory error before the step runs
  (``times`` = how many attempts fail, driving the elastic retry);
- ``sdc_bitflip_param`` / ``sdc_bitflip_grad`` / ``sdc_device_sticky`` —
  one low bit flipped in a parameter after the update, in a gradient
  before it, or in every step's parameters and the victim device's
  self-test (``MXNET_TPU_TORCH_FAULT_DEVICE``, default 0);
- ``step_time_anomaly`` / ``perf_regression`` — one step-time sample, or
  every number of a perf measurement, inflated
  (``MXNET_TPU_TORCH_FAULT_STEP_TIME_FACTOR``, default 10; the factor
  argument, default 3);
- ``preempt`` — a preemption notice seen at the step boundary.

The kinds of the distributed store, of peers and of pod hosts:

- ``dist_connect_timeout`` — the coordinator connect raises TimeoutError
  (``kvstore.dist.init_distributed``, which retries with backoff);
- ``hang_collective`` — the dist store's all-reduce wedged until its
  collective watchdog fires;
- ``peer_death`` / ``host_death`` / ``coordinator_loss`` — a process
  death at the top of a step attempt (``watchdog.check_peers``): the
  victim rank (``MXNET_TPU_TORCH_FAULT_PEER_RANK``, default 1), every
  rank of the victim host (``MXNET_TPU_TORCH_FAULT_HOST_RANK``, default
  1), or every rank of the coordinator (the lowest live host) leaves with
  ``os._exit(FAULT_EXIT_CODE)``, after one ``fault_exit`` line on
  stderr. ``mxnet_tpu`` marks the victim dead in its one process; here
  the survivors must detect the loss themselves, through the beats or
  the failed collective;
- ``host_hang_collective`` — the victim host's ranks wedge at the step's
  entry (an interruptible sleep); the survivors' collective deadline
  blames that host (``watchdog._stall_suspect_hosts``);
- ``ckpt_partial_pod`` — a simulated death inside the pod commit, after
  this rank's shards and before its commit marker.

The parser knows every kind ``mxnet_tpu`` lists. ``record_corrupt``
(:data:`QUEUED_KINDS`) has no hook in the port: arming it raises
:class:`~mxnet_tpu_torch.base.MXNetError` naming ROADMAP Queue 1 item 10
(the streamed-record reader), so a drill never runs armed and
unexercised.
"""
from __future__ import annotations

import contextlib
import errno
import os
import threading
import time

from ..base import MXNetError
from ..observability import flight as _obs_flight

__all__ = ["FaultInjected", "ReplicaCrash", "DecodeReplicaDead",
           "SimulatedCrash", "InjectedOOM", "SERVING_KINDS",
           "TRAINING_KINDS", "QUEUED_KINDS", "parse_spec", "inject", "arm",
           "disarm", "reset", "active", "get", "stats", "reset_stats",
           "install_from_env", "maybe_nan_batch", "maybe_hang",
           "maybe_replica_crash", "maybe_replica_hang",
           "maybe_replica_nan_storm", "maybe_sdc_serving",
           "maybe_calib_table_drift", "maybe_slo_burn",
           "maybe_rollout_bad_weights", "maybe_canary_slo_regression",
           "maybe_autoscale_flap", "maybe_decode_replica_death",
           "maybe_kv_pool_exhaustion", "maybe_nan_grads",
           "maybe_nonfinite_grad", "checkpoint_write_filter", "maybe_crash",
           "maybe_oom_step", "maybe_perf_regression",
           "maybe_step_time_anomaly", "maybe_sdc_bitflip_param",
           "maybe_sdc_bitflip_grad", "maybe_sdc_sticky_param",
           "maybe_sdc_selftest", "maybe_preempt",
           "maybe_dist_connect_fault", "maybe_peer_death",
           "maybe_host_death", "maybe_coordinator_loss",
           "maybe_host_hang", "FAULT_EXIT_CODE"]

SERVING_KINDS = (
    "nan_serving", "hang_batch", "replica_crash", "replica_hang",
    "replica_nan_storm", "slo_burn", "rollout_bad_weights",
    "canary_slo_regression", "autoscale_flap", "decode_replica_death",
    "kv_pool_exhaustion", "sdc_serving", "int8_calib_mismatch")

# ``mxnet_tpu``'s kinds whose hooks sit in the training runtime (Trainer,
# ShardedTrainer, checkpoints, the dist store, the integrity layer)
TRAINING_KINDS = (
    "nan_grad", "nonfinite_grad", "ckpt_enospc", "ckpt_partial_write",
    "ckpt_shard_corrupt", "ckpt_crash_before_manifest", "ckpt_async_crash",
    "dist_connect_timeout", "hang_step", "hang_collective", "oom_step",
    "peer_death", "host_death", "host_hang_collective", "coordinator_loss",
    "ckpt_partial_pod", "perf_regression", "record_corrupt",
    "step_time_anomaly", "sdc_bitflip_param", "sdc_bitflip_grad",
    "sdc_device_sticky", "preempt")

# training kinds whose hooks are not ported: kind -> ROADMAP Queue 1 item
QUEUED_KINDS = {"record_corrupt": 10}

# the exit code of a process that a peer_death / host_death /
# coordinator_loss fault kills
FAULT_EXIT_CODE = 42


class SimulatedCrash(BaseException):
    """Injected process death (a BaseException, so ordinary ``except
    Exception`` handlers do not swallow it)."""


class FaultInjected(RuntimeError):
    """Base class of injected recoverable errors (a test can tell the
    harness's failure from a real defect)."""


class InjectedOOM(FaultInjected):
    """Injected step OOM (``oom_step``); the elastic retry treats it as a
    ``torch.OutOfMemoryError``."""


class ReplicaCrash(FaultInjected):
    """Injected death of one serving-fleet replica: a thread replica's
    batch fails with it (the router retries elsewhere); a process
    replica's worker turns it into ``os._exit``."""


class DecodeReplicaDead(FaultInjected):
    """Injected death of a decode engine mid-stream: its streams are
    rerouted through the batcher's ``death_sink`` or failed with this
    error, and its KV pages go back to the pool."""


_LOCK = threading.Lock()
_ACTIVE: dict = {}
_STATS = {"faults_armed": 0, "faults_fired": 0}


class _Fault:
    """One armed fault: fires on calls [at_step, at_step + times)."""

    def __init__(self, kind, at_step=0, times=1):
        self.kind = kind
        self.at_step = int(at_step)
        self.times = None if times is None else int(times)
        self.calls = 0
        self.fired = 0

    def should_fire(self):
        with _LOCK:
            step = self.calls
            self.calls += 1
            if step < self.at_step:
                return False
            if self.times is not None and self.fired >= self.times:
                return False
            self.fired += 1
            _STATS["faults_fired"] += 1
        _obs_flight.record("fault", fault=self.kind, call=step)
        return True

    def __repr__(self):
        return (f"_Fault({self.kind!r}, at_step={self.at_step}, "
                f"times={self.times}, calls={self.calls}, "
                f"fired={self.fired})")


def _check_kind(kind):
    if kind in QUEUED_KINDS:
        what = "the streamed-record reader"
        raise MXNetError(
            f"fault kind {kind!r} hooks into {what}, which the port does "
            f"not instrument yet (ROADMAP Queue 1 item {QUEUED_KINDS[kind]}"
            "); arming it would inject nothing")
    if kind in SERVING_KINDS or kind in TRAINING_KINDS:
        return
    raise MXNetError(f"unknown fault kind {kind!r} (serving kinds: "
                     f"{', '.join(SERVING_KINDS)})")


def arm(kind, at_step=0, times=1):
    """Arm a fault; returns its record (``.fired`` counts its fires)."""
    _check_kind(kind)
    fault = _Fault(kind, at_step, times)
    with _LOCK:
        _ACTIVE[kind] = fault
        _STATS["faults_armed"] += 1
    return fault


def disarm(kind):
    with _LOCK:
        _ACTIVE.pop(kind, None)


def reset():
    """Disarm everything (tests call this between cases)."""
    with _LOCK:
        _ACTIVE.clear()


def active(kind=None):
    if kind is None:
        return bool(_ACTIVE)
    return kind in _ACTIVE


def get(kind):
    return _ACTIVE.get(kind)


@contextlib.contextmanager
def inject(kind, at_step=0, times=1):
    """Arm ``kind`` for the block; yields its record."""
    fault = arm(kind, at_step, times)
    try:
        yield fault
    finally:
        disarm(kind)


def stats():
    return dict(_STATS)


def reset_stats():
    for k in _STATS:
        _STATS[k] = 0


def parse_spec(spec):
    """``"kind[@at_step[:times]],..."`` -> ``[(kind, at_step, times)]``
    (``times`` None for ``*``), the form ``MXNET_TPU_TORCH_FAULTS``
    takes. Parses every kind ``mxnet_tpu`` lists; arming decides which
    the port can honour."""
    out = []
    for item in (spec or "").split(","):
        item = item.strip()
        if not item:
            continue
        at_step, times = 0, 1
        kind, _, addr = item.partition("@")
        if addr:
            s, _, t = addr.partition(":")
            at_step = int(s)
            if t:
                times = None if t == "*" else int(t)
        if kind not in SERVING_KINDS and kind not in TRAINING_KINDS:
            raise MXNetError(f"unknown fault kind {kind!r} in {spec!r}")
        out.append((kind, at_step, times))
    return out


def install_from_env():
    """Arm every fault ``MXNET_TPU_TORCH_FAULTS`` names (done once at
    import; a spawned process replica inherits the variable)."""
    for kind, at_step, times in parse_spec(
            os.environ.get("MXNET_TPU_TORCH_FAULTS", "")):
        arm(kind, at_step=at_step, times=times)


# --------------------------------------------------------------------- hooks
# Each hook is called unconditionally; the `if not _ACTIVE` early-out keeps
# the disarmed cost to one dict truthiness check.

def _is_float(a):
    import numpy as np

    if hasattr(a, "is_floating_point"):
        return a.is_floating_point()
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _nan_like(a):
    import numpy as np

    if hasattr(a, "is_floating_point"):
        import torch

        return torch.full_like(a, float("nan"))
    return np.full_like(np.asarray(a), np.nan)


def _poison_first_float(fault, feeds, kind):
    """Replace the first floating-point entry of ``feeds`` (dict name ->
    tensor or array) with NaNs, consuming one fire of ``fault``. The
    victim is found BEFORE the fire window is consumed: an all-integer
    batch (token ids) must fail the drill loudly, not burn the fire."""
    target = next((name for name, v in feeds.items() if _is_float(v)),
                  None)
    if target is None:
        raise FaultInjected(
            f"{kind} armed but the batch has no floating-point input "
            f"to poison (inputs: {list(feeds)})")
    if not fault.should_fire():
        return feeds
    out = dict(feeds)
    out[target] = _nan_like(feeds[target])
    return out


def maybe_nan_batch(feeds):
    """Poison one inference batch (``nan_serving``), just before the
    Predictor runs it."""
    if not _ACTIVE:
        return feeds
    fault = _ACTIVE.get("nan_serving")
    if fault is None:
        return feeds
    return _poison_first_float(fault, feeds, "nan_serving")


def _hang_until_interrupted(point):
    """The injected hang: short interruptible sleeps, so the watchdog's
    asynchronous StallError can land between bytecodes. Capped
    (``MXNET_TPU_TORCH_FAULT_HANG_CAP``, default 30 s) so a broken
    watchdog fails the test instead of hanging it."""
    cap = float(os.environ.get("MXNET_TPU_TORCH_FAULT_HANG_CAP", "30"))
    deadline = time.monotonic() + cap
    while time.monotonic() < deadline:
        time.sleep(0.005)
    raise FaultInjected(
        f"injected hang at {point} ran its full {cap:.0f}s cap without "
        "being interrupted — is the watchdog armed for this phase?")


def maybe_hang(point):
    """Wedge the calling thread at ``point`` (``hang_batch``,
    ``hang_step``, ``hang_collective``)."""
    if not _ACTIVE:
        return
    fault = _ACTIVE.get(point)
    if fault is None or not fault.should_fire():
        return
    _hang_until_interrupted(point)


# Fleet replica faults fire only on the replica MXNET_TPU_TORCH_FAULT_REPLICA
# names (default 0), checked BEFORE the fire window is consumed.

def _fault_replica_target():
    return int(os.environ.get("MXNET_TPU_TORCH_FAULT_REPLICA", "0"))


def maybe_replica_crash(replica_id):
    """Raise :class:`ReplicaCrash` in the victim replica's serving path."""
    if not _ACTIVE:
        return
    fault = _ACTIVE.get("replica_crash")
    if fault is None or int(replica_id) != _fault_replica_target():
        return
    if fault.should_fire():
        raise ReplicaCrash(
            f"injected crash of serving replica {replica_id}")


def maybe_replica_hang(replica_id):
    """Wedge the victim replica's batch in an interruptible sleep."""
    if not _ACTIVE:
        return
    fault = _ACTIVE.get("replica_hang")
    if fault is None or int(replica_id) != _fault_replica_target():
        return
    if fault.should_fire():
        _hang_until_interrupted("replica_hang")


def maybe_replica_nan_storm(replica_id, feeds):
    """Poison the victim replica's batch with NaN (arm with ``times=N``
    for an N-batch storm)."""
    if not _ACTIVE:
        return feeds
    fault = _ACTIVE.get("replica_nan_storm")
    if fault is None or int(replica_id) != _fault_replica_target():
        return feeds
    return _poison_first_float(fault, feeds, "replica_nan_storm")


def _flip_low_bit(a):
    """A copy of ``a`` (tensor or array) with the low bit of its first
    element flipped: finite, tiny, wrong."""
    import numpy as np

    if hasattr(a, "is_floating_point"):
        import torch

        out = a.detach().clone()
        flat = out.reshape(-1)
        if flat.numel():
            bits = {4: torch.int32, 2: torch.int16}.get(
                out.element_size(), torch.uint8)
            view = flat.view(bits)
            view[0] = view[0] ^ 1
        return out
    flat = np.ascontiguousarray(a).ravel().copy()
    if flat.size:
        bits = {4: np.uint32, 2: np.uint16}.get(flat.dtype.itemsize,
                                                np.uint8)
        flat.view(bits)[0] ^= bits(1)
    return flat.reshape(np.shape(a))


def maybe_sdc_serving(replica_id, outputs):
    """Flip one low bit of the victim replica's first floating-point
    output (``sdc_serving``); ``outputs`` is ``(list, n_rows)`` as
    ``predict_raw`` returns it."""
    if not _ACTIVE:
        return outputs
    fault = _ACTIVE.get("sdc_serving")
    if fault is None or int(replica_id) != _fault_replica_target():
        return outputs
    outs, n = outputs
    idx = next((i for i, o in enumerate(outs) if _is_float(o)), None)
    if idx is None:
        raise FaultInjected("sdc_serving armed but the replica's outputs "
                            "hold no floating-point array")
    if not fault.should_fire():
        return outputs
    outs = list(outs)
    outs[idx] = _flip_low_bit(outs[idx])
    return outs, n


def maybe_calib_table_drift(table):
    """A stale clone of ``table`` when ``int8_calib_mismatch`` fires (its
    model digest matches no model), so ``quantize_model``'s validation
    must refuse it."""
    if not _ACTIVE:
        return table
    fault = _ACTIVE.get("int8_calib_mismatch")
    if fault is None or not fault.should_fire():
        return table
    return table.stale_clone()


def maybe_slo_burn(counters):
    """``counters`` (the fleet SLO triple) with
    ``MXNET_TPU_TORCH_FAULT_SLO_BURN_N`` (default 64) extra requests that
    all missed their deadline, when ``slo_burn`` fires."""
    if not _ACTIVE:
        return counters
    fault = _ACTIVE.get("slo_burn")
    if fault is None or not fault.should_fire():
        return counters
    n = int(os.environ.get("MXNET_TPU_TORCH_FAULT_SLO_BURN_N", "64"))
    out = dict(counters)
    out["fleet_requests"] = out.get("fleet_requests", 0) + n
    out["fleet_deadline_exceeded"] = \
        out.get("fleet_deadline_exceeded", 0) + n
    return out


def maybe_rollout_bad_weights(params):
    """The candidate ``params`` with its first floating-point entry
    replaced by NaNs (same name, shape and dtype, so it passes the swap's
    validation and must be caught by the canary's health gate)."""
    if not _ACTIVE:
        return params
    fault = _ACTIVE.get("rollout_bad_weights")
    if fault is None:
        return params
    target = next((name for name, v in params.items() if _is_float(v)),
                  None)
    if target is None:
        raise FaultInjected(
            "rollout_bad_weights armed but the candidate has no "
            f"floating-point parameter to poison (params: {list(params)})")
    if not fault.should_fire():
        return params
    out = dict(params)
    out[target] = _nan_like(params[target])
    return out


def maybe_canary_slo_regression(seconds):
    """One canary latency sample inflated
    ``MXNET_TPU_TORCH_FAULT_CANARY_SLO_X`` (default 10) times."""
    if not _ACTIVE:
        return seconds
    fault = _ACTIVE.get("canary_slo_regression")
    if fault is None or not fault.should_fire():
        return seconds
    try:
        factor = float(os.environ.get(
            "MXNET_TPU_TORCH_FAULT_CANARY_SLO_X", "10"))
    except ValueError:
        factor = 10.0
    return seconds * factor


def maybe_autoscale_flap(queue_depth):
    """The autoscaler's queue signal replaced by a square wave: odd fires
    read ``MXNET_TPU_TORCH_FAULT_FLAP_QUEUE`` (default 1e6), even fires
    0.0."""
    if not _ACTIVE:
        return queue_depth
    fault = _ACTIVE.get("autoscale_flap")
    if fault is None or not fault.should_fire():
        return queue_depth
    try:
        high = float(os.environ.get("MXNET_TPU_TORCH_FAULT_FLAP_QUEUE",
                                    "1e6"))
    except ValueError:
        high = 1e6
    return high if fault.fired % 2 == 1 else 0.0


def maybe_decode_replica_death():
    """Raise :class:`DecodeReplicaDead` between decode token steps."""
    if not _ACTIVE:
        return
    fault = _ACTIVE.get("decode_replica_death")
    if fault is None or not fault.should_fire():
        return
    raise DecodeReplicaDead("injected decode engine death mid-stream")


def maybe_kv_pool_exhaustion(available):
    """0 free pages, whatever ``available`` is, when
    ``kv_pool_exhaustion`` fires."""
    if not _ACTIVE:
        return available
    fault = _ACTIVE.get("kv_pool_exhaustion")
    if fault is None or not fault.should_fire():
        return available
    return 0


# ------------------------------------------------------------ training hooks

def maybe_nan_grads(params):
    """Poison the first trainable gradient of ``params`` (gluon
    Parameters) with NaN, in place (``nan_grad``; gluon ``Trainer``)."""
    if not _ACTIVE:
        return False
    fault = _ACTIVE.get("nan_grad")
    if fault is None or not fault.should_fire():
        return False
    for p in params:
        if getattr(p, "grad_req", "write") == "null":
            continue
        p.grad().mul_(float("nan"))
        return True
    return False


def maybe_nonfinite_grad(params, where="grad"):
    """Poison one targeted layer with NaN (``nonfinite_grad``): the
    parameter ``MXNET_TPU_TORCH_FAULT_NONFINITE_LAYER`` names (a substring
    of its name), by default the middle trainable one. ``where="grad"``
    poisons its gradient (the eager Trainer), ``"param"`` its weight (a
    captured step). Returns the parameter's name, or None."""
    if not _ACTIVE:
        return None
    fault = _ACTIVE.get("nonfinite_grad")
    if fault is None:
        return None
    cands = [p for p in params if getattr(p, "grad_req", "write") != "null"]
    if not cands:
        return None
    want = os.environ.get("MXNET_TPU_TORCH_FAULT_NONFINITE_LAYER",
                          "").strip()
    if want:
        target = next((p for p in cands if want in p.name), None)
        if target is None:
            raise FaultInjected(
                f"nonfinite_grad armed but no parameter matches "
                f"MXNET_TPU_TORCH_FAULT_NONFINITE_LAYER={want!r} "
                f"(params: {[p.name for p in cands]})")
    else:
        target = cands[len(cands) // 2]
    if not fault.should_fire():
        return None
    victim = target.data() if where == "param" else target.grad()
    with _no_grad():
        victim.mul_(float("nan"))
    return target.name


def _no_grad():
    import torch

    return torch.no_grad()


def checkpoint_write_filter(path, data):
    """Every checkpoint byte write passes here: it may raise ENOSPC
    (``ckpt_enospc``), come back cut short (``ckpt_partial_write``), or
    have one byte of an array payload flipped (``ckpt_shard_corrupt``:
    same length, so only the CRC catches it)."""
    if not _ACTIVE:
        return data
    fault = _ACTIVE.get("ckpt_enospc")
    if fault is not None and fault.should_fire():
        raise OSError(errno.ENOSPC,
                      "No space left on device [injected fault]", str(path))
    fault = _ACTIVE.get("ckpt_partial_write")
    if fault is not None and fault.should_fire():
        return data[:max(1, len(data) // 2)]
    fault = _ACTIVE.get("ckpt_shard_corrupt")
    if fault is not None and data:
        parts = str(path).replace(os.sep, "/").split("/")
        if "arrays" in parts and fault.should_fire():
            out = bytearray(data)
            out[len(out) // 2] ^= 0xFF
            return bytes(out)
    return data


def maybe_crash(point):
    """Raise :class:`SimulatedCrash` when the fault ``point`` fires."""
    if not _ACTIVE:
        return
    fault = _ACTIVE.get(point)
    if fault is not None and fault.should_fire():
        raise SimulatedCrash(f"injected crash at {point}")


def maybe_oom_step():
    """Raise :class:`InjectedOOM` before the step runs (``oom_step``)."""
    if not _ACTIVE:
        return
    fault = _ACTIVE.get("oom_step")
    if fault is not None and fault.should_fire():
        raise InjectedOOM("CUDA out of memory while running the training "
                          "step [injected fault]")


def maybe_perf_regression(measured, factor=3.0):
    """``measured`` ({key: {metric: value}}) with every number times
    ``factor`` when ``perf_regression`` fires."""
    if not _ACTIVE:
        return measured
    fault = _ACTIVE.get("perf_regression")
    if fault is None or not fault.should_fire():
        return measured
    return {key: {m: (v * factor if isinstance(v, (int, float))
                      and not isinstance(v, bool) else v)
                  for m, v in metrics.items()}
            for key, metrics in measured.items()}


def maybe_step_time_anomaly(dur_ns):
    """One step-time sample times ``MXNET_TPU_TORCH_FAULT_STEP_TIME_FACTOR``
    (default 10) when ``step_time_anomaly`` fires (the step-time drift
    rule's intake)."""
    if not _ACTIVE:
        return dur_ns
    fault = _ACTIVE.get("step_time_anomaly")
    if fault is None or not fault.should_fire():
        return dur_ns
    try:
        factor = float(os.environ.get(
            "MXNET_TPU_TORCH_FAULT_STEP_TIME_FACTOR", "10"))
    except ValueError:
        factor = 10.0
    return int(dur_ns * factor)


def _flip_in_place(t):
    """Flip the low bit of ``t``'s first element, in place (a captured
    step's tensors must keep their addresses)."""
    import torch

    flat = t.detach().reshape(-1)[:1]
    bits = {4: torch.int32, 2: torch.int16}.get(t.element_size(),
                                               torch.uint8)
    with torch.no_grad():
        flat.view(bits).bitwise_xor_(1)


def _first_float(tree, kind):
    target = next((name for name in sorted(tree)
                   if _is_float(tree[name]) and tree[name].numel()), None)
    if target is None:
        raise FaultInjected(
            f"{kind} armed but there is no floating-point leaf to corrupt "
            f"(leaves: {sorted(tree)})")
    return target


def _flip_first_float(tree, kind):
    fault = _ACTIVE.get(kind)
    if fault is None:
        return tree
    target = _first_float(tree, kind)
    if fault.should_fire():
        _flip_in_place(tree[target])
    return tree


def maybe_sdc_bitflip_param(params):
    """One low bit flipped, in place, in the first floating parameter of
    ``params`` after the update (``sdc_bitflip_param``): only the
    fingerprint audit sees it."""
    if not _ACTIVE:
        return params
    return _flip_first_float(params, "sdc_bitflip_param")


def maybe_sdc_bitflip_grad(grads):
    """One low bit flipped, in place, in the first floating gradient
    before the update (``sdc_bitflip_grad``)."""
    if not _ACTIVE:
        return grads
    return _flip_first_float(grads, "sdc_bitflip_grad")


def _fault_device_target():
    return int(os.environ.get("MXNET_TPU_TORCH_FAULT_DEVICE", "0"))


def maybe_sdc_sticky_param(params, device_id):
    """The step side of a lying device (``sdc_device_sticky``): while the
    step runs on the victim device, every fire flips a parameter bit."""
    if not _ACTIVE or _ACTIVE.get("sdc_device_sticky") is None:
        return params
    if int(device_id) != _fault_device_target():
        return params
    return _flip_first_float(params, "sdc_device_sticky")


def maybe_sdc_selftest(result, device_id):
    """The attribution side of ``sdc_device_sticky``: the victim device's
    known-answer self-test result (a numpy array) with one bit flipped."""
    if not _ACTIVE:
        return result
    fault = _ACTIVE.get("sdc_device_sticky")
    if fault is None or int(device_id) != _fault_device_target():
        return result
    if not fault.should_fire():
        return result
    out = result.copy()
    out.ravel()[0] ^= 1
    return out


def maybe_preempt():
    """True once when ``preempt`` fires: a preemption notice seen at the
    step boundary."""
    if not _ACTIVE:
        return False
    fault = _ACTIVE.get("preempt")
    return fault is not None and fault.should_fire()


install_from_env()


# ------------------------------------------------- the store, peers, hosts

def maybe_dist_connect_fault():
    """An unreachable coordinator in ``kvstore.dist.init_distributed``
    (``dist_connect_timeout``)."""
    if not _ACTIVE:
        return
    fault = _ACTIVE.get("dist_connect_timeout")
    if fault is not None and fault.should_fire():
        raise TimeoutError("coordinator connect timed out [injected fault]")


def _exit_victim(kind, **who):
    """The victim process's death: one ``fault_exit`` line on stderr (the
    time a drill measures detection from), then ``os._exit``: no cleanup,
    as after a kill."""
    import json
    import sys

    _obs_flight.record("fault_exit", fault=kind, **who)
    line = json.dumps({"fault_exit": kind, "pid": os.getpid(),
                       "time": time.time(), **who})
    try:
        sys.stdout.flush()
        sys.stderr.write(line + "\n")
        sys.stderr.flush()
    finally:
        os._exit(FAULT_EXIT_CODE)


def maybe_peer_death(rank):
    """``peer_death``: when it fires and ``rank`` is the victim
    (``MXNET_TPU_TORCH_FAULT_PEER_RANK``, default 1) this process exits.
    Every rank calls it at the same steps, so the fire window is the
    same everywhere."""
    if not _ACTIVE:
        return
    fault = _ACTIVE.get("peer_death")
    if fault is not None and fault.should_fire() and int(rank) == int(
            os.environ.get("MXNET_TPU_TORCH_FAULT_PEER_RANK", "1")):
        _exit_victim("peer_death", rank=int(rank))


def maybe_host_death(host):
    """``host_death``: every rank of the victim host
    (``MXNET_TPU_TORCH_FAULT_HOST_RANK``, default 1) exits."""
    if not _ACTIVE:
        return
    fault = _ACTIVE.get("host_death")
    if fault is not None and fault.should_fire() and int(host) == int(
            os.environ.get("MXNET_TPU_TORCH_FAULT_HOST_RANK", "1")):
        _exit_victim("host_death", host=int(host))


def maybe_coordinator_loss(host, coordinator):
    """``coordinator_loss``: every rank of the coordinator host (the
    lowest live host, ``coordinator``) exits."""
    if not _ACTIVE:
        return
    fault = _ACTIVE.get("coordinator_loss")
    if fault is not None and fault.should_fire() and coordinator is not None \
            and int(host) == int(coordinator):
        _exit_victim("coordinator_loss", host=int(host))


def maybe_host_hang(host):
    """``host_hang_collective``: the victim host's ranks
    (``MXNET_TPU_TORCH_FAULT_HOST_RANK``, default 1) wedge at the step's
    entry until a watchdog interrupts them."""
    if not _ACTIVE:
        return
    fault = _ACTIVE.get("host_hang_collective")
    if fault is not None and fault.should_fire() and int(host) == int(
            os.environ.get("MXNET_TPU_TORCH_FAULT_HOST_RANK", "1")):
        _hang_until_interrupted("host_hang_collective")

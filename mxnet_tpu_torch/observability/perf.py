"""Performance attribution (port of ``mxnet_tpu/observability/perf.py``):
the perf ledger of captured graphs, opt-in device timing, and the MFU /
roofline gauges.

1. **The ledger.** Every graph ``capture.CapturedExec`` captures records
   one entry keyed ``<label>@<fingerprint16>``, the fingerprint being
   ``capture.fingerprint`` of the owner's program identity and the
   graph's signature: the FLOPs of one run (torch's FLOP table, the one
   ``torch.utils.flop_counter.FlopCounterMode`` uses, over the first
   warm-up run, plus what the port's own kernels report through
   :func:`add_flops`, which no aten table can see), the peak device
   memory from warm-up to the end of the capture
   (``torch.cuda.max_memory_allocated``), the bytes of the graph's
   static inputs and outputs, and the capture's wall time.
2. **Device time.** With ``MXNET_TPU_TORCH_OBS_DEVICE_TIME=1`` (or
   :func:`set_device_time`) every replay is bracketed by CUDA events and
   synchronized: the entry's ``device_ms`` (EWMA) and a retroactive
   ``perf.device_execute`` span. Off by default: the synchronize
   serializes the host with the card.
3. **Gauges.** ``mfu = flops / (device_s * peak_flops)`` and
   ``roofline_fraction = bytes / (device_s * peak_bw)`` against the
   device's nominal peaks (:func:`nominal_peaks`: the H100 SXM's 989
   TFLOP/s bf16 dense and 3.35 TB/s; override with
   ``MXNET_TPU_TORCH_PERF_PEAK_FLOPS`` / ``..._PERF_PEAK_GBPS``).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time

from . import _STATS
from . import metrics as _metrics

__all__ = ["LEDGER_FIELDS", "note_compile", "note_execution", "timed_call",
           "ledger", "device_timed_entries", "ledger_key", "snapshot",
           "clear", "update_gauges", "device_time_enabled",
           "set_device_time", "nominal_peaks", "count_flops", "add_flops"]

_LOCK = threading.Lock()
_LEDGER: dict = {}

LEDGER_FIELDS = (
    "label",           # capture-site label (sharded_step, trainer_step, ...)
    "fingerprint",     # program + signature identity the key derives from
    "backend",         # "cuda" or "cpu"
    "compiles",        # captures of this key in this process
    "compile_ms",      # wall time of the latest warm-up + capture
    "aot_hit",         # always False: no AOT cache in the port
    "flops",           # FLOPs of one run (aten FLOP table + own kernels)
    "bytes_accessed",  # static input + output bytes of the graph
    "peak_hbm_bytes",  # peak device memory allocated, warm-up to capture
    "argument_bytes",  # static input bytes
    "output_bytes",    # static output bytes
    "temp_bytes",      # peak minus what was allocated before the capture
    "generated_code_bytes",  # 0: a graph has no code of its own
    "device_calls",    # event-timed replays
    "device_ms",       # EWMA of the event time per replay
    "dispatch_ms",     # EWMA of the host's replay call
    "mfu",             # flops / (device_s * nominal peak flops)
    "roofline_fraction",  # bytes_accessed / (device_s * nominal bandwidth)
    "t",               # wall-clock of the latest capture
)

_DEVICE_TIME = os.environ.get("MXNET_TPU_TORCH_OBS_DEVICE_TIME", "").strip() \
    in ("1", "true", "on", "yes")

_EWMA = 0.3

# (peak FLOP/s, peak bytes/s): the H100 SXM's dense bf16 tensor-core rate
# and HBM3 bandwidth (NVIDIA's data sheet); a CPU's for completeness
_NOMINAL_PEAKS = {
    "cuda": (989.0e12, 3.35e12),
    "cpu": (2.0e11, 5.0e10),
}

_FLOP_SINKS: list = []


def device_time_enabled():
    return _DEVICE_TIME


def set_device_time(flag):
    """Toggle event-timed replays; returns the previous state."""
    global _DEVICE_TIME
    prev = _DEVICE_TIME
    _DEVICE_TIME = bool(flag)
    return prev


def _backend():
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def nominal_peaks(backend=None):
    """(peak FLOP/s, peak bytes/s) of ``backend`` ("cuda" or "cpu";
    default: "cuda" where a card is present), with the env overrides."""
    if backend is None:
        backend = _backend()
    flops, bw = _NOMINAL_PEAKS.get(backend, _NOMINAL_PEAKS["cpu"])
    try:
        flops = float(os.environ.get("MXNET_TPU_TORCH_PERF_PEAK_FLOPS")
                      or flops)
    except ValueError:
        pass
    try:
        bw = float(os.environ.get("MXNET_TPU_TORCH_PERF_PEAK_GBPS") or 0) \
            * 1e9 or bw
    except ValueError:
        pass
    return flops, bw


def ledger_key(label, fingerprint):
    fp = (fingerprint or "").strip()
    return f"{label}@{fp[:16] if fp else 'none'}"


def _flop_mode(box):
    """A dispatch mode that adds each aten op's FLOPs (torch's
    ``flop_counter.flop_registry``, FlopCounterMode's table) to
    ``box["aten_flops"]``. Thread-local, unlike FlopCounterMode, whose
    module tracker hooks every module's forward in every thread (a
    serving replica warming up beside another)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                box["aten_flops"] += int(count(*args, **kwargs,
                                               out_val=out))
            return out

    return _Count()


@contextlib.contextmanager
def count_flops():
    """Count the FLOPs of the block: each aten op's by torch's FLOP table
    (the one ``FlopCounterMode`` uses), plus what the port's own kernels
    report (:func:`add_flops`). Yields a dict whose ``"flops"`` is set
    when the block ends. Counts this thread's work only."""
    box = {"flops": 0, "aten_flops": 0, "kernel_flops": 0,
           "thread": threading.get_ident()}
    _FLOP_SINKS.append(box)
    try:
        with _flop_mode(box):
            yield box
    finally:
        _FLOP_SINKS.remove(box)
    box["flops"] = box["aten_flops"] + box["kernel_flops"]


def add_flops(n):
    """A kernel of the port reports its FLOPs to the open
    :func:`count_flops` of its thread (the aten table sees only aten
    ops)."""
    me = threading.get_ident()
    for box in list(_FLOP_SINKS):
        if box["thread"] == me:
            box["kernel_flops"] += int(n)


def _new_entry(key, label, fingerprint):
    entry = dict.fromkeys(LEDGER_FIELDS)
    entry.update(label=label, fingerprint=fingerprint or "", compiles=0,
                 device_calls=0, aot_hit=False, generated_code_bytes=0)
    _LEDGER[key] = entry
    _STATS["perf_ledger_entries"] += 1
    return entry


def note_compile(label, fingerprint, flops=None, argument_bytes=0,
                 output_bytes=0, peak_bytes=0, temp_bytes=0, compile_s=0.0,
                 backend=None):
    """Record one capture into the ledger; returns its key."""
    key = ledger_key(label, fingerprint)
    with _LOCK:
        entry = _LEDGER.get(key) or _new_entry(key, label, fingerprint)
        entry.update(backend=backend or _backend(),
                     compile_ms=compile_s * 1e3, flops=flops,
                     argument_bytes=int(argument_bytes),
                     output_bytes=int(output_bytes),
                     bytes_accessed=int(argument_bytes) + int(output_bytes),
                     peak_hbm_bytes=int(peak_bytes),
                     temp_bytes=int(temp_bytes), t=time.time())
        entry["compiles"] += 1
    return key


def note_execution(label, fingerprint, device_s, dispatch_s=0.0):
    """Fold one timed replay into its entry and refresh MFU / roofline."""
    key = ledger_key(label, fingerprint)
    with _LOCK:
        entry = _LEDGER.get(key) or _new_entry(key, label, fingerprint)
        n = entry["device_calls"]
        ms, disp = device_s * 1e3, dispatch_s * 1e3
        if n == 0 or entry["device_ms"] is None:
            entry["device_ms"], entry["dispatch_ms"] = ms, disp
        else:
            entry["device_ms"] += _EWMA * (ms - entry["device_ms"])
            entry["dispatch_ms"] += _EWMA * (disp - entry["dispatch_ms"])
        entry["device_calls"] = n + 1
        dev_s = entry["device_ms"] / 1e3
        if dev_s > 0:
            peak_flops, peak_bw = nominal_peaks(entry["backend"])
            if entry["flops"]:
                entry["mfu"] = entry["flops"] / (dev_s * peak_flops)
            if entry["bytes_accessed"]:
                entry["roofline_fraction"] = \
                    entry["bytes_accessed"] / (dev_s * peak_bw)
    _STATS["perf_device_timings"] += 1
    return key


def timed_call(fn, args, label, fingerprint, device=None):
    """``fn(*args)``; with device timing on and a CUDA ``device``, between
    two CUDA events and synchronized, the time folded into the ledger and
    recorded as a ``perf.device_execute`` span."""
    if not _DEVICE_TIME or device is None or device.type != "cuda":
        return fn(*args)
    import torch

    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter_ns()
    start.record(stream)
    out = fn(*args)
    end.record(stream)
    t_disp = time.perf_counter_ns()
    end.synchronize()
    t_ready = time.perf_counter_ns()
    device_s = start.elapsed_time(end) / 1e3
    key = note_execution(label, fingerprint, device_s, (t_disp - t0) / 1e9)
    from . import trace as _trace

    _trace.record("perf.device_execute", t0, t_ready - t0, executable=key,
                  host_dispatch_ns=t_disp - t0,
                  device_ns=int(device_s * 1e9))
    return out


def ledger():
    with _LOCK:
        return {k: dict(v) for k, v in _LEDGER.items()}


def device_timed_entries(min_calls=1):
    """Entries with at least ``min_calls`` timed replays (the
    ``perf_device_regression`` rule's view)."""
    with _LOCK:
        return {k: dict(v) for k, v in _LEDGER.items()
                if (v["device_calls"] or 0) >= int(min_calls)
                and v["device_ms"] is not None}


def snapshot():
    peak_flops, peak_bw = nominal_peaks()
    return {"entries": ledger(),
            "peaks": {"flops_per_s": peak_flops, "hbm_bytes_per_s": peak_bw},
            "device_time": _DEVICE_TIME}


def clear():
    with _LOCK:
        _LEDGER.clear()


_PEAK_HBM = _metrics.gauge(
    "mxnet_tpu_executable_peak_hbm_bytes",
    "peak device memory allocated while one graph was warmed up and "
    "captured", labels=("executable",))
_COMPILE_MS = _metrics.gauge(
    "mxnet_tpu_compile_ms", "wall time of the graph's latest capture",
    labels=("executable",))
_EXEC_FLOPS = _metrics.gauge(
    "mxnet_tpu_executable_flops", "FLOPs of one run of the graph",
    labels=("executable",))
_EXEC_BYTES = _metrics.gauge(
    "mxnet_tpu_executable_bytes_accessed",
    "static input + output bytes of the graph", labels=("executable",))
_DEVICE_MS = _metrics.gauge(
    "mxnet_tpu_device_ms", "EWMA event-timed device time per replay "
    "(MXNET_TPU_TORCH_OBS_DEVICE_TIME)", labels=("executable",))
_MFU = _metrics.gauge(
    "mxnet_tpu_mfu", "model FLOPs utilization against the device's "
    "nominal peak", labels=("executable",))
_ROOFLINE = _metrics.gauge(
    "mxnet_tpu_roofline_fraction", "achieved bandwidth fraction against "
    "the device's nominal peak", labels=("executable",))

_PERF_GAUGES = (_PEAK_HBM, _COMPILE_MS, _EXEC_FLOPS, _EXEC_BYTES,
                _DEVICE_MS, _MFU, _ROOFLINE)


def update_gauges():
    """Refresh the per-graph gauges from the ledger (every exporter calls
    it through ``metrics.update_derived``); labelsets whose key left the
    ledger are pruned."""
    entries = ledger()
    for g in _PERF_GAUGES:
        for labelset in g.labelsets():
            key = dict(labelset).get("executable")
            if key not in entries:
                g.remove(executable=key)
    for key, e in entries.items():
        _PEAK_HBM.set(e["peak_hbm_bytes"] or 0, executable=key)
        if e["compile_ms"] is not None:
            _COMPILE_MS.set(e["compile_ms"], executable=key)
        if e["flops"] is not None:
            _EXEC_FLOPS.set(e["flops"], executable=key)
        if e["bytes_accessed"] is not None:
            _EXEC_BYTES.set(e["bytes_accessed"], executable=key)
        if e["device_calls"]:
            _DEVICE_MS.set(e["device_ms"], executable=key)
        if e["mfu"] is not None:
            _MFU.set(e["mfu"], executable=key)
        if e["roofline_fraction"] is not None:
            _ROOFLINE.set(e["roofline_fraction"], executable=key)

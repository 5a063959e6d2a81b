"""Profiler frontend (port of ``mxnet_tpu/profiler.py``; parity:
python/mxnet/profiler.py set_config / set_state / dump / dumps / pause /
resume).

``set_state("run")`` starts a ``torch.profiler.profile`` with CPU activity
and, where a card is present, CUDA activity (CUPTI); ``set_state("stop")``
ends it. :func:`dump` writes its Chrome trace to ``filename`` with the
host-side events of :class:`Task` / :class:`Frame` / :class:`Event` /
:func:`scope` and the :class:`Counter` values appended; :func:`dumps`
returns the aggregate tables (host events, the device kernels by name,
the runtime counters). :func:`pause` and :func:`resume` suspend the
host-side events.

The dispatch ring keeps the last ``MXNET_TPU_TORCH_DISPATCH_RING`` (64)
ops ``mx.nd`` dispatched (``ndarray.imperative_invoke``), the trail a
watchdog crash report embeds; :func:`dispatch_stats` is every runtime
counter of the port in one flat dict.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque

__all__ = ["set_config", "set_state", "state", "dump", "dumps", "pause",
           "resume", "profiler_set_config", "profiler_set_state", "Task",
           "Frame", "Event", "Counter", "Marker", "scope", "dispatch_stats",
           "reset_dispatch_stats", "dispatch_ring", "record_dispatch",
           "set_dispatch_ring", "last_profile"]

_LOCK = threading.Lock()
_CONFIG = {"filename": "profile.json", "profile_all": False,
           "profile_symbolic": True, "profile_imperative": True,
           "profile_memory": True, "profile_api": True,
           "aggregate_stats": True}
_STATE = "stop"
_PROF = None          # the running torch.profiler.profile
_LAST = None          # the last finished one
_EVENTS = []          # host-side (name, start, dur, category)
_COUNTERS = {}
_PAUSED = False

try:
    _RING_SIZE = int(os.environ.get("MXNET_TPU_TORCH_DISPATCH_RING", "64"))
except ValueError:
    _RING_SIZE = 64
_DISPATCH_RING = deque(maxlen=_RING_SIZE) if _RING_SIZE > 0 else None
_DISPATCH_SEQ = itertools.count(1)


def set_dispatch_ring(size):
    """Resize (``size <= 0``: disable) the dispatch ring; returns the
    previous size."""
    global _DISPATCH_RING
    prev = _DISPATCH_RING.maxlen if _DISPATCH_RING is not None else 0
    size = int(size)
    _DISPATCH_RING = deque(maxlen=size) if size > 0 else None
    return prev


def record_dispatch(name):
    """Append one dispatched op to the ring (``imperative_invoke``'s hot
    path)."""
    ring = _DISPATCH_RING
    if ring is not None:
        ring.append((next(_DISPATCH_SEQ), time.perf_counter(), name))


def dispatch_ring():
    """The last dispatched ops, oldest first: ``{"seq", "t", "op"}``."""
    if _DISPATCH_RING is None:
        return []
    return [{"seq": s, "t": t, "op": n} for s, t, n in list(_DISPATCH_RING)]


def set_config(**kwargs):
    """Configure the profiler: ``filename`` names :func:`dump`'s output;
    the other keys are kept for parity."""
    with _LOCK:
        _CONFIG.update(kwargs)


profiler_set_config = set_config


def set_state(state="stop", profile_process="worker"):
    """'run' starts the torch profiler (CPU, and CUDA where a card is
    present), 'stop' ends it."""
    global _STATE, _PROF, _LAST
    import torch

    if state not in ("run", "stop"):
        raise ValueError("state must be 'run' or 'stop'")
    with _LOCK:
        if state == "run" and _STATE == "stop":
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            _PROF = torch.profiler.profile(activities=acts)
            _PROF.__enter__()
        elif state == "stop" and _STATE == "run":
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            _PROF.__exit__(None, None, None)
            _LAST, _PROF = _PROF, None
        _STATE = state


profiler_set_state = set_state


def state():
    return _STATE


def last_profile():
    """The last finished ``torch.profiler.profile`` (None before one
    ran): its ``key_averages()`` and ``events()`` for analysis."""
    return _LAST


def pause(profile_process="worker"):
    """Suspend host-side event collection."""
    global _PAUSED
    _PAUSED = True


def resume(profile_process="worker"):
    global _PAUSED
    _PAUSED = False


def _host_events():
    with _LOCK:
        events = [{"name": name, "cat": cat, "ph": "X", "ts": t0 * 1e6,
                   "dur": dur * 1e6, "pid": os.getpid(), "tid": 0}
                  for name, t0, dur, cat in _EVENTS]
        events += [{"name": name, "ph": "C", "ts": time.time() * 1e6,
                    "pid": os.getpid(), "args": {name: value}}
                   for name, value in _COUNTERS.items()]
    return events


def dump(finished=True, profile_process="worker"):
    """Write the Chrome trace to ``filename``: the last (or running)
    profile's events, the host-side events and the counters."""
    prof = _PROF if _PROF is not None else _LAST
    path = _CONFIG.get("filename", "profile.json")
    trace = {"traceEvents": []}
    if prof is not None and _PROF is None:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        if isinstance(trace, list):
            trace = {"traceEvents": trace}
    trace.setdefault("traceEvents", []).extend(_host_events())
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(trace, f)
    os.replace(tmp, path)
    return path


def dispatch_stats(reset=False):
    """Every runtime counter of the port (capture, serving, resilience,
    observability) as one flat dict."""
    from .observability import runtime_counters

    stats = runtime_counters()
    if reset:
        reset_dispatch_stats()
    return stats


def reset_dispatch_stats():
    import sys

    from . import observability

    for name in ("mxnet_tpu_torch.capture", "mxnet_tpu_torch.serving",
                 "mxnet_tpu_torch.resilience"):
        mod = sys.modules.get(name)
        if mod is not None:
            mod.reset_stats()
    observability.reset_stats()


def dumps(reset=False, format="table", sort_by="total", ascending=False):
    """The aggregate tables: host events by name, the last profile's
    device kernels by name (device time), and the runtime counters."""
    with _LOCK:
        agg = {}
        for name, _, dur, _cat in _EVENTS:
            tot, cnt = agg.get(name, (0.0, 0))
            agg[name] = (tot + dur, cnt + 1)
        if reset:
            _EVENTS.clear()
    rows = sorted(agg.items(), key=lambda kv: kv[1][0], reverse=not ascending)
    lines = [f"{'Name':<40}{'Count':>8}{'Total(ms)':>12}{'Avg(ms)':>12}"]
    for name, (tot, cnt) in rows:
        lines.append(f"{name:<40}{cnt:>8}{tot * 1e3:>12.3f}"
                     f"{tot / cnt * 1e3:>12.3f}")
    if _LAST is not None:
        lines.append("")
        lines.append(f"{'Device kernel':<60}{'Count':>8}{'Device(ms)':>12}")
        kern = [e for e in _LAST.key_averages()
                if _device_us(e) > 0]
        kern.sort(key=_device_us, reverse=not ascending)
        for e in kern:
            lines.append(f"{e.key[:59]:<60}{e.count:>8}"
                         f"{_device_us(e) / 1e3:>12.3f}")
    lines.append("")
    lines.append(f"{'Dispatch counter':<40}{'Value':>12}")
    for name, value in sorted(dispatch_stats(reset=reset).items()):
        lines.append(f"{name:<40}{value:>12}")
    return "\n".join(lines)


def _device_us(e):
    return float(getattr(e, "device_time_total", None)
                 or getattr(e, "cuda_time_total", 0) or 0)


class _Record:
    def __init__(self, name):
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None or _PAUSED:
            return
        dur = time.perf_counter() - self._t0
        with _LOCK:
            _EVENTS.append((self.name, self._t0, dur,
                            type(self).__name__.lower()))
        self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()


class Task(_Record):
    def __init__(self, name, domain=None):
        super().__init__(name)


class Frame(_Record):
    def __init__(self, name, domain=None):
        super().__init__(name)


class Event(_Record):
    pass


class Marker:
    """Instant marker."""

    def __init__(self, name, domain=None):
        self.name = name

    def mark(self, scope="process"):
        with _LOCK:
            _EVENTS.append((self.name, time.perf_counter(), 0.0, "marker"))


class Counter:
    """Named counter."""

    def __init__(self, name, domain=None, value=0):
        self.name = name
        with _LOCK:
            _COUNTERS[name] = value

    def set_value(self, value):
        with _LOCK:
            _COUNTERS[self.name] = value

    def increment(self, delta=1):
        with _LOCK:
            _COUNTERS[self.name] = _COUNTERS.get(self.name, 0) + delta

    def decrement(self, delta=1):
        self.increment(-delta)


@contextlib.contextmanager
def scope(name="<unk>:", append_mode=False):
    """A profiler scope: a host event, and a ``record_function`` range so
    the torch profile's events carry the name."""
    import torch

    ev = Event(name)
    ev.start()
    try:
        with torch.profiler.record_function(name.rstrip(":")):
            yield
    finally:
        ev.stop()

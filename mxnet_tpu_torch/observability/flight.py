"""Always-on flight recorder: one bounded chronological event log (port
of ``mxnet_tpu/observability/flight.py``).

Any subsystem calls :func:`record` with a ``kind`` and flat fields; the
event lands in one ring ordered by a global sequence number (a dict build
and a deque append under a lock). Kinds the serving runtime records:
``span`` (root-span ends), ``fault`` (an armed fault fired), ``stall`` (a
watchdog deadline expired), ``peer`` (a rank declared dead), ``fleet`` (a
replica state transition), ``operator`` (an autoscaler or rollout
decision) and ``alert`` (a rule went FIRING or RESOLVED).

The ring holds ``MXNET_TPU_TORCH_OBS_FLIGHT_RING`` events (default 1024,
``0`` disables; :func:`set_ring` resizes it at run time). Watchdog crash
reports embed :func:`snapshot`'s tail.
"""
from __future__ import annotations

import itertools
import os
import threading
import time

from . import _STATS

__all__ = ["record", "events", "snapshot", "clear", "set_ring",
           "ring_size", "last_seq", "set_host", "host"]

from collections import deque

_LOCK = threading.Lock()
try:
    _RING_SIZE = int(os.environ.get("MXNET_TPU_TORCH_OBS_FLIGHT_RING",
                                    "1024"))
except ValueError:
    _RING_SIZE = 1024
_RING = deque(maxlen=_RING_SIZE) if _RING_SIZE > 0 else None
_SEQ = itertools.count(1)
_LAST_SEQ = 0
_HOST = None  # pod host rank stamped onto every event (None = untagged)


def set_host(host):
    """Tag every later event with this process's pod host rank
    (``watchdog.configure_pod`` calls it); ``None`` removes the tag.
    Returns the previous value."""
    global _HOST
    prev = _HOST
    _HOST = None if host is None else int(host)
    return prev


def host():
    """The pod host rank events are tagged with, or None."""
    return _HOST


def set_ring(size):
    """Resize (or with ``size <= 0`` disable) the flight ring at
    runtime; returns the previous size. Existing events are kept up to
    the new capacity (newest win)."""
    global _RING
    size = int(size)
    with _LOCK:
        prev = _RING.maxlen if _RING is not None else 0
        if size > 0:
            _RING = deque(_RING or (), maxlen=size)
        else:
            _RING = None
    return prev


def ring_size():
    with _LOCK:
        return _RING.maxlen if _RING is not None else 0


def record(kind, **fields):
    """Append one event. ``fields`` must be flat JSON-serializable
    values (the crash-report writer stringifies anything else). Events
    carry the pod host rank once :func:`set_host` was called (an explicit
    ``host=`` field wins). Returns the event's sequence number, or 0 when
    the recorder is disabled."""
    global _LAST_SEQ
    if _RING is None:
        return 0
    event = {"seq": 0, "t": time.time(), "ns": time.perf_counter_ns(),
             "kind": str(kind)}
    if _HOST is not None:
        event["host"] = _HOST
    for k, v in fields.items():
        if k == "host" or k not in event:  # kind/seq/t/ns: the recorder's
            event[k] = v
    with _LOCK:
        # seq is drawn under the same lock hold as the append, so ring
        # order always equals seq order and last_seq() is a sound
        # "events after this" bookmark
        seq = event["seq"] = next(_SEQ)
        if _RING is not None:
            _RING.append(event)
        _LAST_SEQ = seq
    _STATS["obs_flight_events"] += 1
    return seq


def events(kind=None, since_seq=0):
    """Events currently in the ring, oldest first; optionally filtered
    to one ``kind`` and/or to events after ``since_seq`` (use
    :func:`last_seq` to bookmark)."""
    with _LOCK:
        out = list(_RING) if _RING is not None else []
    if kind is not None:
        out = [e for e in out if e["kind"] == kind]
    if since_seq:
        out = [e for e in out if e["seq"] > since_seq]
    return out


def snapshot(limit=None):
    """The ring's tail (newest ``limit`` events, oldest first) — the
    form watchdog crash reports embed."""
    with _LOCK:
        out = list(_RING) if _RING is not None else []
    if limit is not None and limit >= 0:
        out = out[-limit:]
    return out


def last_seq():
    """The most recently issued sequence number (a bookmark for
    ``events(since_seq=...)``); monotonic even across ring overflow
    and :func:`clear`."""
    with _LOCK:
        return _LAST_SEQ


def clear():
    with _LOCK:
        if _RING is not None:
            _RING.clear()

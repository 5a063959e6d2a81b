"""mxnet_tpu_torch.serving — the inference runtime (subset of
``mxnet_tpu/serving``).

- :class:`Predictor` wraps an initialized Block and runs one batch per
  ``predict`` call, padded to the nearest declared batch bucket and sliced
  back to the caller's rows.
- :class:`BatchServer` is a thread-safe dynamic batcher over a Predictor:
  concurrent ``submit()`` calls return futures, requests coalesce up to
  ``max_batch_size`` rows or ``batch_timeout_ms``, and each future gets
  exactly its own rows.

Counters and request-latency percentiles come from :func:`stats`.
"""
from __future__ import annotations

import threading as _threading
from collections import deque as _deque

# Counters are defined BEFORE the submodule imports at the bottom so
# predictor.py / batcher.py can `from . import _STATS` during package init.
_STATS = {
    # Predictor
    "serving_predict_calls": 0,    # predict()/predict_raw() invocations
    "serving_bucket_hits": 0,      # predict() on a bucket already run
    "serving_bucket_misses": 0,    # first run of a bucket
    "serving_unbucketed": 0,       # batches larger than every bucket
    "serving_batch_samples": 0,    # rows executed (bucket-padded)
    "serving_padded_samples": 0,   # of which padding (waste)
    # BatchServer
    "serving_requests": 0,         # accepted submits
    "serving_batches": 0,          # coalesced batch executions
    "serving_queue_peak": 0,       # high-water mark of queued requests
}

_LAT_LOCK = _threading.Lock()
_LATENCIES = _deque(maxlen=8192)  # seconds, submit -> result


def record_latency(seconds):
    with _LAT_LOCK:
        _LATENCIES.append(seconds)


def _percentile_us(sorted_lat, q):
    if not sorted_lat:
        return 0
    idx = min(len(sorted_lat) - 1, int(q * (len(sorted_lat) - 1) + 0.5))
    return int(sorted_lat[idx] * 1e6)


def stats():
    """All serving counters as one flat dict, with request-latency
    percentiles over the last 8192 completed requests."""
    out = dict(_STATS)
    with _LAT_LOCK:
        lat = sorted(_LATENCIES)
    out["serving_p50_latency_us"] = _percentile_us(lat, 0.50)
    out["serving_p99_latency_us"] = _percentile_us(lat, 0.99)
    return out


def reset_stats():
    for k in _STATS:
        _STATS[k] = 0
    with _LAT_LOCK:
        _LATENCIES.clear()


from .predictor import Predictor  # noqa: E402
from .batcher import BatchServer, ServerClosed  # noqa: E402

__all__ = ["Predictor", "BatchServer", "ServerClosed", "stats",
           "reset_stats", "record_latency"]

"""mxnet_tpu_torch.serving — the inference runtime (port of
``mxnet_tpu/serving``).

- :class:`Predictor` serves a Symbol with its params (fp32 or, with
  ``quantize="int8"``, the calibrated full-int8 graph) or an initialized
  Block, one batch per ``predict`` call, padded to the nearest declared
  batch bucket and sliced back to the caller's rows.
- :class:`BatchServer` is a thread-safe dynamic batcher over a Predictor:
  concurrent ``submit()`` calls return futures, requests coalesce up to
  ``max_batch_size`` rows or ``batch_timeout_ms``, and each future gets
  exactly its own rows. Requests carry deadlines
  (:class:`DeadlineExceeded`), the queue sheds at its high-water mark
  (:class:`ServerOverloaded`), and every batch's outputs pass the
  :class:`~mxnet_tpu_torch.resilience.HealthSentinel` under the batch
  watchdog.
- :class:`Fleet` (``serving/fleet.py``) supervises N replicas of each
  model (threads, or spawned processes) behind a :class:`Router` that
  balances by outstanding work, retries on another replica with the
  remaining deadline, hedges, circuit-breaks and sheds with
  :class:`FleetOverloaded`; :class:`StreamRouter` does the same for
  decode streams. :class:`Autoscaler` and :class:`RolloutManager`
  (``serving/operator.py``) scale the fleet and roll weights out through
  a canary.
- :class:`DecodePredictor` (``serving/decode.py``) is the generative decode
  engine over a ``TransformerLM``: a paged KV cache in a :class:`PagePool`,
  bucketed prefill, one fixed-shape step through K4 and a flat probe
  forward, each a CUDA graph on the card.
- :class:`DecodeBatcher` batches decode continuously, token by token, over
  a DecodePredictor, streaming each sequence's tokens to a
  :class:`TokenStream`.

Counters, request-latency percentiles and decode's time-to-first-token and
inter-token percentiles come from :func:`stats`.
"""
from __future__ import annotations

import threading as _threading
import weakref as _weakref
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
    "serving_quantized_predictors": 0,  # Predictor.quantize() rewrites
    # BatchServer
    "serving_requests": 0,         # accepted submits
    "serving_batches": 0,          # coalesced batch executions
    "serving_shed_deadline": 0,    # requests failed on expired deadline
    "serving_shed_overload": 0,    # requests shed at the queue high-water
    "serving_poisoned_batches": 0, # batches the health check rejected
    "serving_stalled_batches": 0,  # batches the watchdog timed out
    "serving_queue_peak": 0,       # high-water mark of queued requests
    # Fleet (serving/fleet.py: Router + ReplicaSupervisor)
    "fleet_requests": 0,           # requests admitted by the router
    "fleet_retries": 0,            # attempts re-routed to another replica
    "fleet_hedges": 0,             # duplicate tail-latency attempts sent
    "fleet_hedge_wins": 0,         # requests a hedge attempt answered first
    "fleet_breaker_opens": 0,      # circuit breakers tripped open
    "fleet_half_open_probes": 0,   # re-admission trials through a breaker
    "fleet_probe_failures": 0,     # supervisor health probes that failed
    "fleet_replica_failures": 0,   # attempt failures charged to a replica
    "fleet_restarts": 0,           # replica rebuilds (DEAD -> RESTARTING)
    "fleet_drains": 0,             # replicas drained out of rotation
    "fleet_shed_overloaded": 0,    # requests shed with FleetOverloaded
    "fleet_deadline_exceeded": 0,  # router-side deadline expiries
    # Operator (serving/operator.py: Autoscaler + RolloutManager)
    "fleet_scale_up": 0,           # replicas admitted by scale-up
    "fleet_scale_down": 0,         # replicas drained out by scale-down
    "fleet_scale_hold": 0,         # autoscaler evaluations that held steady
    "rollout_promotions": 0,       # canaried artifacts promoted fleet-wide
    "rollout_rollbacks": 0,        # artifacts rolled back on a gate failure
    "rollout_holds": 0,            # rollouts held (no-op: same artifact)
    # Decode (serving/decode.py + DecodeBatcher in serving/batcher.py)
    "decode_sequences": 0,         # sequences admitted to the decode engine
    "decode_tokens": 0,            # tokens emitted across all sequences
    "decode_prefills": 0,          # bucketed prefill executions
    "decode_steps": 0,             # fixed-shape decode step executions
    "decode_evictions": 0,         # sequences retired (finished/cancelled)
    "decode_preemptions": 0,       # sequences bounced back to admission
    "decode_backpressure": 0,      # page allocations refused (pool empty)
    "decode_pages_inuse_peak": 0,  # high-water mark of allocated KV pages
    "decode_ttft_misses": 0,       # first tokens slower than the TTFT SLO
    "decode_reroutes": 0,          # streams resumed on another replica
}

_LAT_LOCK = _threading.Lock()
_LATENCIES = _deque(maxlen=8192)  # seconds, submit -> result


def record_latency(seconds):
    with _LAT_LOCK:
        _LATENCIES.append(seconds)


# Decode's two latencies: time to first token (submit -> first streamed
# token, prefill included) and inter-token latency (the gap between two
# consecutive tokens of one sequence).
_TTFT = _deque(maxlen=4096)   # seconds, submit -> first token
_ITL = _deque(maxlen=8192)    # seconds, token[i] -> token[i+1]


def record_ttft(seconds):
    with _LAT_LOCK:
        _TTFT.append(seconds)


def record_itl(seconds):
    with _LAT_LOCK:
        _ITL.append(seconds)


def _percentile_us(sorted_lat, q):
    if not sorted_lat:
        return 0
    idx = min(len(sorted_lat) - 1, int(q * (len(sorted_lat) - 1) + 0.5))
    return int(sorted_lat[idx] * 1e6)


# Live fleets, for stats()/reset_stats(): per-replica request latency
# lives on the replica objects (they come and go with restarts), so the
# module keeps weak references to the Fleet fronts and pulls.
_FLEETS_LOCK = _threading.Lock()
_FLEETS = _weakref.WeakSet()


def _register_fleet(fleet):
    with _FLEETS_LOCK:
        _FLEETS.add(fleet)


def _live_fleets():
    with _FLEETS_LOCK:
        return list(_FLEETS)


def stats():
    """All serving counters as one flat dict, with request-latency
    percentiles over the last 8192 completed requests, for live fleets
    the fleet-level p50/p99 and a per-replica summary string
    (``model/rid p50=..us p99=..us n=..``), and decode's TTFT (last 4096)
    and inter-token (last 8192) percentiles."""
    out = dict(_STATS)
    with _LAT_LOCK:
        lat = sorted(_LATENCIES)
        ttft = sorted(_TTFT)
        itl = sorted(_ITL)
    out["serving_p50_latency_us"] = _percentile_us(lat, 0.50)
    out["serving_p99_latency_us"] = _percentile_us(lat, 0.99)
    fleet_lat = []
    summaries = []
    for f in _live_fleets():
        f._collect_latencies(fleet_lat, summaries)
    fleet_lat.sort()
    out["fleet_p50_latency_us"] = _percentile_us(fleet_lat, 0.50)
    out["fleet_p99_latency_us"] = _percentile_us(fleet_lat, 0.99)
    out["fleet_replica_latency_us"] = "; ".join(summaries)
    out["decode_p50_ttft_us"] = _percentile_us(ttft, 0.50)
    out["decode_p99_ttft_us"] = _percentile_us(ttft, 0.99)
    out["decode_p50_itl_us"] = _percentile_us(itl, 0.50)
    out["decode_p99_itl_us"] = _percentile_us(itl, 0.99)
    return out


def reset_stats():
    for k in _STATS:
        _STATS[k] = 0
    with _LAT_LOCK:
        _LATENCIES.clear()
        _TTFT.clear()
        _ITL.clear()
    for f in _live_fleets():
        f._reset_latencies()


from .predictor import Predictor  # noqa: E402
from .batcher import (BatchServer, DeadlineExceeded, ServerClosed,  # noqa: E402
                      ServerOverloaded, DecodeBatcher, TokenStream)
from .fleet import (Fleet, FleetClosed, FleetOverloaded,  # noqa: E402
                    ReplicaSupervisor, Router, StreamRouter)
from .operator import Autoscaler, RolloutManager  # noqa: E402
from .decode import DecodePredictor, PagePool  # noqa: E402

__all__ = ["Predictor", "BatchServer", "DeadlineExceeded", "ServerClosed",
           "ServerOverloaded", "Fleet", "FleetClosed", "FleetOverloaded",
           "ReplicaSupervisor", "Router", "Autoscaler", "RolloutManager",
           "DecodePredictor", "PagePool", "DecodeBatcher", "TokenStream",
           "StreamRouter", "stats", "reset_stats", "record_latency",
           "record_ttft", "record_itl"]

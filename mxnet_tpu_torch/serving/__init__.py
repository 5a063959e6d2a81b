"""mxnet_tpu_torch.serving — the inference runtime (subset of
``mxnet_tpu/serving``).

- :class:`Predictor` serves a Symbol with its params (fp32 or, with
  ``quantize="int8"``, the calibrated full-int8 graph) or an initialized
  Block, one batch per ``predict`` call, padded to the nearest declared
  batch bucket and sliced back to the caller's rows.
- :class:`BatchServer` is a thread-safe dynamic batcher over a Predictor:
  concurrent ``submit()`` calls return futures, requests coalesce up to
  ``max_batch_size`` rows or ``batch_timeout_ms``, and each future gets
  exactly its own rows.
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
    "serving_queue_peak": 0,       # high-water mark of queued requests
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


def stats():
    """All serving counters as one flat dict, with request-latency
    percentiles over the last 8192 completed requests and decode's TTFT
    (last 4096) and inter-token (last 8192) percentiles."""
    out = dict(_STATS)
    with _LAT_LOCK:
        lat = sorted(_LATENCIES)
        ttft = sorted(_TTFT)
        itl = sorted(_ITL)
    out["serving_p50_latency_us"] = _percentile_us(lat, 0.50)
    out["serving_p99_latency_us"] = _percentile_us(lat, 0.99)
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


from .predictor import Predictor  # noqa: E402
from .batcher import (BatchServer, ServerClosed, DecodeBatcher,  # noqa: E402
                      TokenStream)
from .decode import DecodePredictor, PagePool  # noqa: E402

__all__ = ["Predictor", "BatchServer", "ServerClosed", "DecodePredictor",
           "PagePool", "DecodeBatcher", "TokenStream", "stats",
           "reset_stats", "record_latency", "record_ttft", "record_itl"]

"""mxnet_tpu_torch.observability — runtime introspection (port of
``mxnet_tpu/observability``).

- :mod:`trace` — structured span tracing: ``trace.span(name, **attrs)``
  opens one timed span under a thread-local context; spans nest, cross
  threads (``trace.context``) and cross the fleet's process-replica pipe
  (``collect`` in the child, ``ingest`` in the parent). Off by default
  (``MXNET_TPU_TORCH_OBS_TRACE``); a disabled span is one shared no-op.
- :mod:`metrics` — counters, gauges and histograms with labels, a
  ring-buffered time series, the Prometheus text and JSON-lines
  exporters, and the fleet / decode SLO gauges derived from the serving
  layer on every export.
- :mod:`flight` — the always-on flight recorder: one bounded event log of
  root-span ends, fired faults, watchdog stalls, fleet transitions,
  operator decisions and alert transitions.
- :mod:`alerts` — the serving and training rules (SLO burn rates,
  breaker and healthy-floor probes, decode TTFT burn, input stall, step
  time drift, device-time regression, sentinel skip spikes, the numerics
  conditions, silent data corruption), their OK / PENDING / FIRING state
  machine and the incidents they open.
- :mod:`numerics` — the numerics tap of the captured training step.
- :mod:`perf` — the perf ledger of captured graphs (FLOPs, peak memory,
  device time) and the MFU / roofline gauges.
- :mod:`traceview` — span records as a Chrome trace.

The names of metrics, spans, counters and flight events are
``mxnet_tpu``'s, so the two packages' records compare one to one.
"""
from __future__ import annotations

# Counters are defined BEFORE the submodule imports at the bottom so
# trace.py / metrics.py / flight.py can `from . import _STATS`.
_STATS = {
    "obs_spans": 0,            # span records placed in the local ring
    "obs_spans_shipped": 0,    # span records ingested from replica pipes
    "obs_flight_events": 0,    # flight-recorder events recorded
    "obs_metric_flushes": 0,   # JSON-lines exporter flushes
    "obs_metric_samples": 0,   # time-series ring samples taken
    "obs_dumps": 0,            # observability.dump() calls
    "alert_evaluations": 0,          # alert-engine evaluation rounds
    "alert_transitions": 0,          # FIRING/RESOLVED state transitions
    "alert_incidents_opened": 0,     # incidents assembled on FIRING
    "alert_incidents_resolved": 0,   # incidents closed on RESOLVED
    "numerics_samples": 0,           # tapped steps emitted
    "numerics_nonfinite_steps": 0,   # sampled steps with NaN/Inf
    "numerics_halts": 0,             # halt-policy raises
    "numerics_snapshots": 0,         # divergence snapshots published
    "perf_ledger_entries": 0,        # perf ledger keys created
    "perf_device_timings": 0,        # device-timed executions folded in
}


def stats():
    """The observability counters as one flat dict."""
    return dict(_STATS)


def reset_stats():
    for k in _STATS:
        _STATS[k] = 0


# modules whose stats()/reset_stats() the profiler's dispatch_stats()
# merges and reset_dispatch_stats() zeroes (read only once imported)
_COUNTER_MODULES = ("mxnet_tpu_torch.capture", "mxnet_tpu_torch.serving",
                    "mxnet_tpu_torch.resilience",
                    "mxnet_tpu_torch.gluon.data.dataloader",
                    "mxnet_tpu_torch.io.stream")


def runtime_counters():
    """Every flat runtime counter of the port in one dict: capture,
    serving, resilience, the input path (the DataLoader and the stream
    layer) and observability (the port's counterpart of
    ``mxnet_tpu``'s ``profiler.dispatch_stats()``, which the exporters
    and crash reports read)."""
    import sys

    out = {}
    for name in _COUNTER_MODULES + ("mxnet_tpu_torch.resilience.checkpoint",
                                    "mxnet_tpu_torch.resilience.elastic",
                                    "mxnet_tpu_torch.resilience.integrity"):
        mod = sys.modules.get(name)
        if mod is not None:
            try:
                out.update(mod.stats())
            except Exception:
                pass
    out.update(stats())
    return out


from . import trace  # noqa: E402
from . import metrics  # noqa: E402
from . import flight  # noqa: E402
from . import alerts  # noqa: E402
from . import numerics  # noqa: E402
from . import perf  # noqa: E402
from . import traceview  # noqa: E402

# with MXNET_TPU_TORCH_METRICS_FILE set, the background JSON-lines flusher
# arms itself when the runtime imports this layer (no-op otherwise)
metrics.maybe_start_flusher()


def dump(limit=None):
    """One snapshot of the whole layer: the flight recorder (oldest
    first), the ended-span ring, the metrics registry and its time
    series, the alert rules and incidents, and the runtime counters."""
    _STATS["obs_dumps"] += 1
    return {
        "schema_version": 2,
        "flight": flight.snapshot(limit=limit),
        "spans": trace.spans(),
        "metrics": metrics.snapshot(),
        "series": metrics.series(),
        "alerts": alerts.snapshot(),
        "incidents": alerts.incidents(),
        "numerics": numerics.snapshot_state(),
        "perf": perf.snapshot(),
        "counters": runtime_counters(),
    }


__all__ = ["trace", "metrics", "flight", "alerts", "numerics", "perf",
           "traceview", "dump", "stats",
           "reset_stats", "runtime_counters"]

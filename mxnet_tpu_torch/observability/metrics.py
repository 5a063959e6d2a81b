"""Typed metrics registry with labels, a time series and two exporters
(port of ``mxnet_tpu/observability/metrics.py``).

- Instruments: :func:`counter` (monotonic), :func:`gauge` (last value) and
  :func:`histogram` (bucketed distribution with sum and count), each with
  a tuple of label names (``c.inc(1, model="lm")``).
- :func:`sample` appends a snapshot of every instrument to a ring of
  ``MXNET_TPU_TORCH_METRICS_RING`` samples (default 512).
- :func:`render_prometheus` gives the text exposition (the typed
  instruments, then every flat runtime counter as ``mxnet_tpu_<name>``);
  :func:`flush_json` appends one JSON line to
  ``MXNET_TPU_TORCH_METRICS_FILE`` (a daemon flusher runs every
  ``MXNET_TPU_TORCH_METRICS_FLUSH_S`` once :func:`start_flusher` arms it).
- :func:`update_derived` refreshes the fleet SLO gauges (deadline hit
  rate, shed rate, p50 / p99, breaker and healthy-replica states) and the
  decode SLO gauges from the serving layer, then gives the alert engine
  its tick; every exporter calls it.

Metric names are ``mxnet_tpu``'s, so both packages export the same series.
"""
from __future__ import annotations

import bisect
import json
import os
import threading
import time

from collections import deque

from . import _STATS

__all__ = ["counter", "gauge", "histogram", "get", "registry",
           "snapshot", "sample", "series", "render_prometheus",
           "flush_json", "start_flusher", "stop_flusher",
           "update_slo", "update_decode_slo", "update_input_stall",
           "update_derived",
           "slo_counters",
           "decode_counters",
           "note_span", "reset", "Counter", "Gauge", "Histogram",
           "update_pod"]

_LOCK = threading.Lock()
_REGISTRY: dict = {}

try:
    _SERIES_SIZE = int(os.environ.get("MXNET_TPU_TORCH_METRICS_RING",
                                      "512"))
except ValueError:
    _SERIES_SIZE = 512
_SERIES = deque(maxlen=max(1, _SERIES_SIZE))

# default latency-style buckets (milliseconds)
DEFAULT_BUCKETS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0, 2500.0, 10000.0)


def _labelset(labels, values):
    if set(values) != set(labels):
        raise ValueError(
            f"metric labels are {sorted(labels)}, got {sorted(values)}")
    return tuple((k, str(values[k])) for k in labels)


class _Metric:
    kind = "untyped"

    def __init__(self, name, help, labels):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._lock = threading.Lock()
        self._data: dict = {}

    def labelsets(self):
        with self._lock:
            return list(self._data)

    def value(self, **labels):
        with self._lock:
            return self._data.get(_labelset(self.labels, labels))

    def remove(self, **labels):
        """Drop one labelset's cell (derived gauges prune series whose
        subject — a replica, an executable — no longer exists, so
        exporters don't accrete unbounded label cardinality and stale
        frozen values)."""
        with self._lock:
            self._data.pop(_labelset(self.labels, labels), None)

    def _snapshot(self):
        with self._lock:
            return dict(self._data)

    def _reset(self):
        with self._lock:
            self._data.clear()


class Counter(_Metric):
    kind = "counter"

    def inc(self, value=1, **labels):
        if value < 0:
            raise ValueError("counters are monotonic; use a gauge")
        key = _labelset(self.labels, labels)
        with self._lock:
            self._data[key] = self._data.get(key, 0) + value


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value, **labels):
        key = _labelset(self.labels, labels)
        with self._lock:
            self._data[key] = value

    def inc(self, value=1, **labels):
        key = _labelset(self.labels, labels)
        with self._lock:
            self._data[key] = self._data.get(key, 0) + value


class Histogram(_Metric):
    """Bucketed distribution. Internal bucket counts are PER-BUCKET
    (non-cumulative), one extra overflow slot at the end — one bisect +
    one increment per observe, the hot-path shape; the Prometheus
    renderer produces the cumulative ``le`` form."""

    kind = "histogram"

    def __init__(self, name, help, labels, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def _snapshot(self):
        # copy each cell under the lock: one consistent point snapshot
        # keeps the rendered cumulative series monotone
        with self._lock:
            return {k: {"count": c["count"], "sum": c["sum"],
                        "buckets": list(c["buckets"])}
                    for k, c in self._data.items()}

    def _cell(self, key):
        cell = self._data.get(key)
        if cell is None:
            cell = {"count": 0, "sum": 0.0,
                    "buckets": [0] * (len(self.buckets) + 1)}
            self._data[key] = cell
        return cell

    def observe(self, value, **labels):
        key = _labelset(self.labels, labels)
        value = float(value)
        with self._lock:
            cell = self._cell(key)
            cell["count"] += 1
            cell["sum"] += value
            cell["buckets"][bisect.bisect_left(self.buckets, value)] += 1

    def percentile(self, q, **labels):
        """Approximate percentile from the bucket boundaries (the
        upper edge of the bucket the q-quantile falls in); None when
        the labelset has no observations."""
        cell = self.value(**labels)
        if not cell or not cell["count"]:
            return None
        rank = q * cell["count"]
        seen = 0
        for i, le in enumerate(self.buckets):
            seen += cell["buckets"][i]
            if seen >= rank:
                return le
        return float("inf")


def _register(cls, name, help, labels, **kw):
    with _LOCK:
        m = _REGISTRY.get(name)
        if m is not None:
            if type(m) is not cls or tuple(labels) != m.labels:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind} with "
                    f"labels {m.labels}")
            return m
        m = cls(name, help, labels, **kw)
        _REGISTRY[name] = m
        return m


def counter(name, help="", labels=()):
    """Register (idempotently) and return a monotonic Counter."""
    return _register(Counter, name, help, labels)


def gauge(name, help="", labels=()):
    return _register(Gauge, name, help, labels)


def histogram(name, help="", labels=(), buckets=DEFAULT_BUCKETS):
    return _register(Histogram, name, help, labels, buckets=buckets)


def get(name):
    with _LOCK:
        return _REGISTRY.get(name)


def registry():
    with _LOCK:
        return dict(_REGISTRY)


def reset():
    """Zero every instrument's data (registrations survive — the
    catalog is code structure, the values are run state)."""
    for m in registry().values():
        m._reset()
    with _LOCK:
        _SERIES.clear()
        _SPAN_CELLS.clear()


# -------------------------------------------------------- built-in series

# The span-duration histogram every ended span feeds (trace.py): one
# instrument, one label — the span name — so the whole span taxonomy is
# exportable without a registration per instrumentation site.
_SPAN_MS = histogram(
    "mxnet_tpu_span_ms",
    "duration of ended trace spans, by span name", labels=("name",))

# Fleet SLO gauges, derived from the live serving layer by update_slo().
_SLO_HIT_RATE = gauge(
    "mxnet_tpu_fleet_deadline_hit_rate",
    "fraction of admitted fleet requests not lost to their deadline")
_SLO_SHED_RATE = gauge(
    "mxnet_tpu_fleet_shed_rate",
    "fraction of admitted fleet requests shed as overloaded")
_SLO_P50 = gauge("mxnet_tpu_fleet_p50_us",
                 "fleet request latency p50 (us)", labels=("model",))
_SLO_P99 = gauge("mxnet_tpu_fleet_p99_us",
                 "fleet request latency p99 (us)", labels=("model",))
_SLO_BREAKER = gauge(
    "mxnet_tpu_fleet_breaker_open",
    "1 when the replica's circuit breaker is open",
    labels=("model", "replica"))
_SLO_HEALTHY = gauge(
    "mxnet_tpu_fleet_healthy_replicas",
    "replicas currently in HEALTHY rotation", labels=("model",))

# Decode-streaming SLO gauges, derived from the serving layer's
# TTFT/ITL sliding windows by update_decode_slo() on the same exporter
# cadence as the fleet family.
_DECODE_TTFT_P50 = gauge(
    "mxnet_tpu_decode_ttft_p50_us",
    "decode time-to-first-token p50 (us), sliding window")
_DECODE_TTFT_P99 = gauge(
    "mxnet_tpu_decode_ttft_p99_us",
    "decode time-to-first-token p99 (us), sliding window")
_DECODE_ITL_P99 = gauge(
    "mxnet_tpu_decode_itl_p99_us",
    "decode inter-token latency p99 (us), sliding window")
_DECODE_TTFT_HIT = gauge(
    "mxnet_tpu_decode_ttft_hit_rate",
    "fraction of admitted decode sequences whose first token met the "
    "TTFT SLO (MXNET_TPU_TORCH_DECODE_TTFT_SLO_MS)")


def _ratio(num, den):
    """num/den with the zero-denominator edge pinned to 0.0 — a derived
    rate over an empty window must export 0 (or stay absent), never NaN
    or a ZeroDivisionError that kills the exporter thread."""
    return num / den if den else 0.0


def slo_counters():
    """The cumulative fleet SLO counter triple (requests, deadline
    misses, overload sheds) every SLO consumer — :func:`update_slo`'s
    gauges and the alert engine's burn-rate windows — reads, with the
    ``slo_burn`` fault hook applied upstream of both: the chaos drill
    inflates deadline misses HERE, so the injected burn flows through
    the real derivation and window math, never a shortcut."""
    import sys

    serving = sys.modules.get("mxnet_tpu_torch.serving")
    if serving is None:
        return {}
    counters = {
        "fleet_requests": serving._STATS["fleet_requests"],
        "fleet_deadline_exceeded":
            serving._STATS["fleet_deadline_exceeded"],
        "fleet_shed_overloaded": serving._STATS["fleet_shed_overloaded"],
    }
    try:
        from ..resilience import faults
    except Exception:
        return counters
    return faults.maybe_slo_burn(counters)


def update_slo(counters=None):
    """Refresh the ``mxnet_tpu_fleet_*`` gauges from the live serving
    layer. Called by every exporter; safe (and cheap) with no fleet.
    Division edges are explicit: a zero-request window leaves the rate
    gauges absent (no data is not a 0% hit rate), an empty fleet or a
    model with zero replicas reports 0 healthy replicas and 0-latency
    percentiles rather than NaN. Per-model/replica labelsets whose
    subject left the live fleet set are pruned (the
    same discipline as every derived family) so a closed fleet's breaker
    cell cannot export ``open=1`` forever. ``counters`` reuses a
    :func:`slo_counters` view already taken this tick
    (``update_derived`` passes one shared view to the gauges AND the
    alert engine, so a bounded-``times`` ``slo_burn`` arm inflates
    both identically instead of burning one fire per consumer)."""
    import sys

    serving = sys.modules.get("mxnet_tpu_torch.serving")
    if serving is None:
        return
    if counters is None:
        counters = slo_counters()
    s_requests = counters.get("fleet_requests", 0)
    if s_requests > 0:
        _SLO_HIT_RATE.set(1.0 - _ratio(
            counters["fleet_deadline_exceeded"], s_requests))
        _SLO_SHED_RATE.set(_ratio(
            counters["fleet_shed_overloaded"], s_requests))
    live_models = set()
    live_replicas = set()
    for fleet in serving._live_fleets():
        try:
            models = fleet.models()
        except Exception:
            continue
        for model in models:
            lat = []
            healthy = 0
            live_models.add(str(model))
            try:
                replicas = fleet._sup.replicas(model)
            except Exception:
                replicas = ()  # a closing fleet's model set can race its
            for r in replicas:  # supervisor teardown: report empty, not die
                lat.extend(r.latency_snapshot())
                healthy += 1 if r.state == "HEALTHY" else 0
                live_replicas.add((str(model), str(r.rid)))
                _SLO_BREAKER.set(1 if r.breaker.is_open else 0,
                                 model=model, replica=r.rid)
            _SLO_HEALTHY.set(healthy, model=model)
            lat.sort()
            # _percentile_us returns 0 for an empty window by contract
            _SLO_P50.set(serving._percentile_us(lat, 0.50), model=model)
            _SLO_P99.set(serving._percentile_us(lat, 0.99), model=model)
    for labelset in _SLO_BREAKER.labelsets():
        d = dict(labelset)
        if (d.get("model"), d.get("replica")) not in live_replicas:
            _SLO_BREAKER.remove(model=d.get("model"),
                                replica=d.get("replica"))
    for g in (_SLO_HEALTHY, _SLO_P50, _SLO_P99):
        for labelset in g.labelsets():
            model = dict(labelset).get("model")
            if model not in live_models:
                g.remove(model=model)


def decode_counters():
    """The decode SLO counter pair (admitted sequences, TTFT SLO
    misses) the ``decode_ttft_burn`` alert rule windows — read from the
    same ``serving._STATS`` the gauges derive from, and empty until the
    serving layer has been imported (same light-process discipline as
    the fleet counters)."""
    import sys

    serving = sys.modules.get("mxnet_tpu_torch.serving")
    if serving is None:
        return {}
    return {
        "decode_sequences": serving._STATS["decode_sequences"],
        "decode_ttft_misses": serving._STATS["decode_ttft_misses"],
    }


def update_decode_slo():
    """Refresh the ``mxnet_tpu_decode_*`` gauges from the serving
    layer's TTFT/ITL sliding windows. Cheap and safe with no decode
    traffic: empty windows leave the percentile gauges absent (no data
    is not a 0 us TTFT) and a zero-sequence run leaves the hit-rate
    gauge absent rather than claiming a perfect SLO."""
    import sys

    serving = sys.modules.get("mxnet_tpu_torch.serving")
    if serving is None:
        return
    with serving._LAT_LOCK:
        ttft = sorted(serving._TTFT)
        itl = sorted(serving._ITL)
    if ttft:
        _DECODE_TTFT_P50.set(serving._percentile_us(ttft, 0.50))
        _DECODE_TTFT_P99.set(serving._percentile_us(ttft, 0.99))
    if itl:
        _DECODE_ITL_P99.set(serving._percentile_us(itl, 0.99))
    seqs = serving._STATS["decode_sequences"]
    if seqs > 0:
        _DECODE_TTFT_HIT.set(1.0 - _ratio(
            serving._STATS["decode_ttft_misses"], seqs))


_INPUT_STALL = gauge(
    "mxnet_tpu_input_stall_fraction",
    "step.data_wait time / observed training-window wall time (first "
    "span start to last span end over data_wait + training-step root "
    "spans); needs MXNET_TPU_TORCH_OBS_TRACE")

_STEP_ROOT_SPANS = ("train.step", "train.sharded_step",
                    "train.captured_step")


def update_input_stall():
    """``mxnet_tpu_input_stall_fraction`` from the ended-span ring: time
    inside ``step.data_wait`` spans over the wall-clock window the
    training spans cover (earliest start to latest end of data_wait and
    step-root spans). Needs tracing on; an empty window reads 0.0."""
    from . import trace as _trace

    wait = 0
    t_min = None
    t_max = None
    for s in _trace.spans():
        if s["name"] == "step.data_wait":
            wait += s["dur_ns"]
        elif s["name"] not in _STEP_ROOT_SPANS:
            continue
        t_min = s["t0_ns"] if t_min is None else min(t_min, s["t0_ns"])
        end = s["t0_ns"] + s["dur_ns"]
        t_max = end if t_max is None else max(t_max, end)
    window = (t_max - t_min) if t_min is not None else 0
    value = min(1.0, _ratio(wait, window))
    _INPUT_STALL.set(value)
    return value


# --------------------------------------------------- derived pod gauges
# The pod liveness view, from the watchdog's host tracker: one picture of
# the whole pod on every host's exporter, so a host-down alert fires from
# any survivor while the dead host's own exporter is gone.
_POD_HOSTS = gauge(
    "mxnet_tpu_pod_hosts",
    "hosts in the pod's current topology (absent when no pod is "
    "configured)")
_POD_HOSTS_LIVE = gauge(
    "mxnet_tpu_pod_hosts_live",
    "pod hosts not currently marked dead by the watchdog liveness layer")
_POD_HOST_UP = gauge(
    "mxnet_tpu_pod_host_up",
    "1 while the labeled pod host is live, 0 once the watchdog marks it "
    "dead (sticky until re-admission)", labels=("host",))


def update_pod():
    """Refresh the ``mxnet_tpu_pod_*`` gauges from the watchdog's pod
    snapshot (``mxnet_tpu/observability/metrics.py:490``). A process with
    no pod leaves every pod series absent; after a shrink the renumbered
    hosts' series replace the old ones. Returns the snapshot, or None."""
    import sys

    watchdog = sys.modules.get("mxnet_tpu_torch.resilience.watchdog")
    if watchdog is None:
        return None
    snap = watchdog.pod_snapshot()
    if not snap.get("configured"):
        for ls in list(_POD_HOST_UP.labelsets()):
            _POD_HOST_UP.remove(**dict(ls))
        return None
    num = int(snap["num_hosts"])
    dead = set(snap["dead_hosts"])
    _POD_HOSTS.set(num)
    _POD_HOSTS_LIVE.set(num - len(dead & set(range(num))))
    current = {str(h) for h in range(num)}
    for ls in list(_POD_HOST_UP.labelsets()):
        if dict(ls).get("host") not in current:
            _POD_HOST_UP.remove(**dict(ls))
    for h in range(num):
        _POD_HOST_UP.set(0.0 if h in dead else 1.0, host=h)
    return snap


def update_derived():
    """Refresh every derived gauge family (fleet SLO, decode SLO, the pod,
    the perf ledger's per-graph gauges, the input-stall fraction) in one
    place, then give the alert engine its evaluation tick. Every exporter
    calls this. One ``slo_counters()`` view is taken per tick and shared
    by the SLO gauges and the alert windows (one ``slo_burn`` hook fire
    per tick, the same inflated view on both sides)."""
    counters = slo_counters()
    update_slo(counters)
    update_decode_slo()
    update_pod()
    from . import alerts as _alerts
    from . import perf as _perf

    _perf.update_gauges()
    stall = update_input_stall()
    _alerts.maybe_evaluate(slo=counters, input_stall=stall)


# per-span-name cell cache for the note_span hot path: skips the
# labelset validation + dict churn of the generic observe() — a traced
# training step ends a handful of spans per millisecond
_SPAN_CELLS: dict = {}


def note_span(name, dur_ns):
    """Trace hook: one ended span -> one histogram observation (the
    fast path of ``mxnet_tpu_span_ms.observe(..., name=name)``)."""
    cell = _SPAN_CELLS.get(name)
    if cell is None:
        # create + cache under ONE registry-lock hold: reset() clears
        # the instrument data first and the cache second (also under
        # _LOCK), so a cell detached by a concurrent reset is always
        # evicted from the cache too — never a ghost cell silently
        # swallowing every later observation of this span name
        with _LOCK:
            with _SPAN_MS._lock:
                cell = _SPAN_MS._cell((("name", str(name)),))
            _SPAN_CELLS[name] = cell
    value = dur_ns / 1e6
    with _SPAN_MS._lock:
        cell["count"] += 1
        cell["sum"] += value
        cell["buckets"][bisect.bisect_left(_SPAN_MS.buckets, value)] += 1


# ------------------------------------------------------------- snapshots

def _escape_label(value):
    """Prometheus text-format label-value escaping (\\ " and newline) —
    one hostile model/tensor name must not fail the whole scrape."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _flat_key(name, labelset):
    if not labelset:
        return name
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labelset)
    return f"{name}{{{inner}}}"


def snapshot():
    """Every instrument's current data as one JSON-friendly dict:
    ``{name: {"kind", "labels", "values": {flat-label-key: value}}}``
    (histogram values are ``{count, sum, buckets}``)."""
    update_derived()
    out = {}
    for name, m in sorted(registry().items()):
        values = {}
        for labelset, v in m._snapshot().items():
            values[_flat_key("", labelset) or ""] = v
        out[name] = {"kind": m.kind, "labels": list(m.labels),
                     "values": values}
        if isinstance(m, Histogram):
            out[name]["buckets"] = list(m.buckets)
    return out


def sample(now=None):
    """Append one time-series sample of every instrument (and the SLO
    gauges) to the ring; returns the sample. Each record carries BOTH
    clocks:
    wall-clock ``t`` (epoch seconds, for humans and dashboards) and
    monotonic ``ns`` (``perf_counter_ns``, what windowed consumers
    like the alert engine difference — wall clock can step)."""
    rec = {"t": time.time() if now is None else now,
           "ns": time.perf_counter_ns(),
           "metrics": snapshot()}
    with _LOCK:
        _SERIES.append(rec)
    _STATS["obs_metric_samples"] += 1
    return rec


def series():
    """The ring-buffered time series, oldest first."""
    with _LOCK:
        return list(_SERIES)


# ------------------------------------------------------------- exporters

def render_prometheus(include_runtime_counters=True):
    """Prometheus text exposition (format 0.0.4): the typed registry
    first, then -- unless disabled -- every numeric flat runtime counter
    (``observability.runtime_counters()``) as an untyped
    ``mxnet_tpu_<name>`` sample."""
    update_derived()
    lines = []
    for name, m in sorted(registry().items()):
        if m.help:
            lines.append(f"# HELP {name} {m.help}")
        lines.append(f"# TYPE {name} {m.kind}")
        data = m._snapshot()
        if isinstance(m, Histogram):
            for labelset, cell in sorted(data.items()):
                cum = 0
                for le, n in zip(m.buckets, cell["buckets"]):
                    cum += n
                    key = _flat_key(name + "_bucket",
                                    labelset + (("le", f"{le:g}"),))
                    lines.append(f"{key} {cum}")
                key = _flat_key(name + "_bucket",
                                labelset + (("le", "+Inf"),))
                lines.append(f"{key} {cell['count']}")
                lines.append(
                    f"{_flat_key(name + '_sum', labelset)} {cell['sum']:g}")
                lines.append(
                    f"{_flat_key(name + '_count', labelset)} "
                    f"{cell['count']}")
        else:
            for labelset, v in sorted(data.items()):
                lines.append(f"{_flat_key(name, labelset)} {v:g}")
    if include_runtime_counters:
        from . import runtime_counters

        counters = runtime_counters()
        for k, v in sorted(counters.items()):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue  # e.g. fleet_replica_latency_us is a summary str
            lines.append(f"# TYPE mxnet_tpu_{k} untyped")
            lines.append(f"mxnet_tpu_{k} {v:g}")
    return "\n".join(lines) + "\n"


def metrics_file():
    return (os.environ.get("MXNET_TPU_TORCH_METRICS_FILE", "").strip()
            or None)


def flush_json(path=None, include_runtime_counters=True, record=None):
    """Append one JSON-lines record — timestamp, the typed-metric
    snapshot, and (by default) the flat runtime counters — to ``path``
    (default ``MXNET_TPU_TORCH_METRICS_FILE``). Returns the path, or None
    when no destination is configured. ``record`` reuses a snapshot
    already taken (the background flusher passes its ``sample()`` so
    each cycle walks the registry/fleet once, not twice)."""
    path = path or metrics_file()
    if not path:
        return None
    rec = dict(record) if record is not None \
        else {"t": time.time(), "metrics": snapshot()}
    if include_runtime_counters:
        from . import runtime_counters

        rec["counters"] = runtime_counters()
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(rec, default=str) + "\n")
    _STATS["obs_metric_flushes"] += 1
    return path


# ------------------------------------------------------ background flusher

_FLUSHER = None
_FLUSHER_STOP = None


def flush_cadence_s():
    raw = os.environ.get("MXNET_TPU_TORCH_METRICS_FLUSH_S", "").strip()
    try:
        v = float(raw) if raw else 10.0
    except ValueError:
        v = 10.0
    return max(0.05, v)


def start_flusher(path=None, cadence_s=None):
    """Start (idempotently) the background JSON-lines flusher daemon:
    every ``cadence_s`` (default ``MXNET_TPU_TORCH_METRICS_FLUSH_S``,
    10 s)
    it takes a time-series :func:`sample` and appends one line to the
    metrics file. No-op when no file is configured. Returns True when
    a flusher is (now) running."""
    global _FLUSHER, _FLUSHER_STOP
    path = path or metrics_file()
    if not path:
        return False
    with _LOCK:
        if _FLUSHER is not None and _FLUSHER.is_alive():
            return True
        stop = threading.Event()

        def loop():
            while not stop.wait(cadence_s or flush_cadence_s()):
                try:
                    flush_json(path, record=sample())
                except Exception:
                    pass  # the exporter must never take the run down
            try:
                # final flush so short runs export too
                flush_json(path, record=sample())
            except Exception:
                pass

        t = threading.Thread(target=loop, name="mxnet-torch-metrics-flush",
                             daemon=True)
        _FLUSHER, _FLUSHER_STOP = t, stop
    t.start()
    return True


def stop_flusher(timeout=2.0):
    """Stop the background flusher (one final flush included)."""
    global _FLUSHER, _FLUSHER_STOP
    with _LOCK:
        t, stop = _FLUSHER, _FLUSHER_STOP
        _FLUSHER = _FLUSHER_STOP = None
    if stop is not None:
        stop.set()
    if t is not None and t.is_alive():
        t.join(timeout)


def maybe_start_flusher():
    """Arm the background flusher iff ``MXNET_TPU_TORCH_METRICS_FILE`` is
    set, so an operator only needs the environment knob."""
    if metrics_file():
        start_flusher()

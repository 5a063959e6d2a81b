"""Alert rules, their state machine and incidents (port of
``mxnet_tpu/observability/alerts.py``).

- Rules, evaluated on the exporter cadence (every
  ``metrics.update_derived()`` call): multi-window SLO burn rates over the
  fleet counters (deadline misses, overload sheds) and decode's TTFT
  misses; live threshold probes (a breaker open, a model under its
  healthy-replica floor, the input-stall fraction, the numerics tap's
  three conditions); the training-step time against median + k*MAD of
  its own history; the perf ledger's device time and MFU against their
  own EWMA; windowed spikes of sentinel skips and of the integrity
  layer's corruption counters.
- Each rule walks ``OK -> PENDING -> FIRING -> OK`` with ``hold_s`` (a
  breach must persist) and ``cooldown_s`` (conditions must stay clean)
  against flapping; every FIRING / RESOLVED transition records one
  ``alert`` flight event.
- A FIRING transition opens one :class:`Incident`: the rule's evidence,
  the flight-recorder slice of its window, the slowest matching span
  trees and the fleet's replica and breaker states.
  :func:`open_incidents` is what the autoscaler reads.

Disabled (``MXNET_TPU_TORCH_ALERTS=0`` or :func:`set_enabled`), the
evaluation site is one global check. ``pod_host_down`` fires from any
survivor once the watchdog's pod liveness layer marks a host dead.
"""
from __future__ import annotations

import itertools
import os
import sys
import threading
import time

from collections import deque

from . import _STATS
from . import flight as _flight
from . import metrics as _metrics
from . import perf as _perf

__all__ = ["AlertRule", "BurnRateRule", "ThresholdRule",
           "StepTimeDriftRule", "PerfLedgerDropRule", "CounterSpikeRule",
           "ALERT_RULE_IDS", "register_rule", "unregister_rule", "rules",
           "get_rule", "evaluate", "maybe_evaluate", "enabled",
           "set_enabled", "incidents", "open_incidents", "snapshot",
           "reset", "Incident"]

_LOCK = threading.Lock()
_RULES: dict = {}
_HISTORY: deque = deque(maxlen=512)   # evaluation observations (windows)
_INCIDENTS: deque = None              # sized below from the env knob
_INCIDENT_IDS = itertools.count(1)
# REAL monotonic time of the last exporter-cadence evaluation. Kept
# separate from any caller-supplied evaluation clock: rate-limiting
# against a synthetic drill clock would let one large `now` suppress
# real exporter ticks until the host clock caught up.
_LAST_TICK = None

_ENABLED = os.environ.get("MXNET_TPU_TORCH_ALERTS", "").strip() not in (
    "0", "false", "off", "no")


def _env_float(name, default):
    try:
        raw = os.environ.get(name, "").strip()
        return float(raw) if raw else default
    except ValueError:
        return default


def _env_int(name, default):
    try:
        raw = os.environ.get(name, "").strip()
        return int(raw) if raw else default
    except ValueError:
        return default


_INCIDENTS = deque(
    maxlen=max(1, _env_int("MXNET_TPU_TORCH_ALERT_INCIDENTS", 64)))

# The rule ids this port registers (a subset of ``mxnet_tpu``'s).
ALERT_RULE_IDS = (
    "slo_deadline_burn",      # fleet deadline-miss burn rate, 2 windows
    "slo_shed_burn",          # fleet overload-shed burn rate, 2 windows
    "fleet_breaker_open",     # any live replica's circuit breaker open
    "fleet_healthy_floor",    # a model's HEALTHY replicas under the floor
    "input_stall_high",       # input-stall fraction over its ceiling
    "step_time_drift",        # step time outside median + k*MAD
    "perf_device_regression",  # ledger device_ms/MFU off its own EWMA
    "health_skip_spike",      # sentinel skips/grad-norm trips spiking
    "numerics_nonfinite",     # numerics tap: non-finite gradient onset
    "numerics_grad_explosion",  # numerics tap: grad norm off median+k*MAD
    "numerics_dead_layer",    # numerics tap: a layer stopped training
    "decode_ttft_burn",       # decode TTFT SLO-miss burn rate, 2 windows
    "pod_host_down",          # a pod host's heartbeat/liveness lost
    "sdc_detected",           # integrity layer caught silent corruption
)


def enabled():
    return _ENABLED


def set_enabled(flag):
    """Turn alert evaluation on/off at runtime (the post-import
    counterpart of ``MXNET_TPU_TORCH_ALERTS``); returns the previous
    state."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(flag)
    return prev


# ------------------------------------------------------------------ context

class _EvalContext:
    """Everything one evaluation round hands the rules: the clock, the
    fresh observation (windowed counters), the history ring, and lazy
    accessors for the live sources (fleets, span ring, perf ledger)."""

    def __init__(self, now, obs, history, input_stall=None):
        self.now = now
        self.obs = obs
        self.history = history
        self.input_stall = input_stall

    def windowed(self, group, key, window_s):
        """Delta of ``history[...][group][key]`` over the trailing
        ``window_s`` seconds (the newest sample at or before
        ``now - window_s``; the oldest sample when the history is
        younger than the window). Returns 0 with fewer than 2 samples."""
        cur = self.obs.get(group, {}).get(key, 0)
        base = None
        for h in self.history:
            if h is self.obs:
                continue
            if h["now"] <= self.now - window_s:
                base = h
            else:
                break
        if base is None:
            for h in self.history:
                if h is not self.obs:
                    base = h
                    break
        if base is None:
            return 0
        return cur - base.get(group, {}).get(key, 0)

    def seq_at(self, window_s):
        """Flight-recorder bookmark at (or before) ``now - window_s`` —
        the start of an incident's evidence slice."""
        seq = None
        for h in self.history:
            seq = h["seq"] if seq is None else seq
            if h["now"] <= self.now - window_s:
                seq = h["seq"]
            else:
                break
        return seq or 0

    def fleets(self):
        try:
            import sys

            serving = sys.modules.get("mxnet_tpu_torch.serving")
            if serving is None:
                return []
            return serving._live_fleets()
        except Exception:
            return []


def _slo_counters():
    """The fleet SLO counter triple the burn-rate rules consume — the
    same ``slo_burn``-hook-applied view ``metrics.update_slo`` derives
    its gauges from (``metrics.slo_counters``), so the drill's injected
    burn reaches gauges and alert windows identically. Empty until the
    serving layer has actually been imported (a light process must not
    drag it in just to evaluate rules)."""
    import sys

    if sys.modules.get("mxnet_tpu_torch.serving") is None:
        return {}
    try:
        return _metrics.slo_counters()
    except Exception:
        return {}


def _decode_counters():
    """The decode SLO counter pair (admitted sequences, TTFT misses)
    the decode burn-rate rule windows — ``metrics.decode_counters``,
    which is itself empty until the serving layer is imported."""
    try:
        return _metrics.decode_counters()
    except Exception:
        return {}


def _health_counters():
    sentinel = sys.modules.get("mxnet_tpu_torch.resilience.sentinel")
    if sentinel is None:
        return {}
    return {k: sentinel._STATS[k] for k in
            ("health_skipped_steps", "sentinel_grad_norm_trips")}


def _integrity_counters():
    integrity = sys.modules.get("mxnet_tpu_torch.resilience.integrity")
    if integrity is None:
        return {}
    return {k: integrity._STATS[k] for k in
            ("integrity_audit_mismatches", "integrity_selftest_failures",
             "integrity_serving_failures", "integrity_ckpt_mismatches")}


# -------------------------------------------------------------------- rules

class AlertRule:
    """One declarative rule. Subclasses implement :meth:`check` ->
    ``(breached, evidence)``; the engine owns the OK/PENDING/FIRING
    state machine, hold/cooldown timing, flight events and incident
    assembly. ``span_names`` hints which span trees make good incident
    exemplars; ``window_s`` sizes the incident's evidence slice."""

    def __init__(self, id, description="", severity="page", hold_s=None,
                 cooldown_s=None, span_names=(), window_s=None):
        self.id = str(id)
        self.description = description
        self.severity = severity
        self.hold_s = (_env_float("MXNET_TPU_TORCH_ALERT_HOLD_S", 0.0)
                       if hold_s is None else float(hold_s))
        self.cooldown_s = (_env_float("MXNET_TPU_TORCH_ALERT_COOLDOWN_S", 60.0)
                           if cooldown_s is None else float(cooldown_s))
        self.span_names = tuple(span_names)
        self.window_s = float(window_s) if window_s is not None else \
            _env_float("MXNET_TPU_TORCH_ALERT_BURN_SLOW_S", 300.0)
        # state machine (engine-owned, under the module lock)
        self.state = "OK"
        self.pending_since = None
        self.last_breach = None
        self.incident_id = None
        self.last_evidence = None

    def check(self, ctx):  # pragma: no cover - abstract
        raise NotImplementedError

    def describe(self):
        return {"id": self.id, "severity": self.severity,
                "state": self.state, "hold_s": self.hold_s,
                "cooldown_s": self.cooldown_s,
                "description": self.description}


class BurnRateRule(AlertRule):
    """Multi-window SLO burn rate (the SRE alerting shape): with an
    objective of e.g. 99% deadline hit-rate the error budget is 1%,
    and ``burn = windowed_error_rate / budget``. The rule fires only
    when BOTH the fast and the slow window burn at >= ``factor``×
    budget — the fast window gives detection latency, the slow window
    keeps a one-sample blip from paging."""

    def __init__(self, id, num_key, den_key, objective=None, fast_s=None,
                 slow_s=None, factor=None, group="slo", **kw):
        self.num_key = num_key
        self.den_key = den_key
        self.group = group  # observation group the windows read
        self.objective = (_env_float("MXNET_TPU_TORCH_ALERT_SLO_TARGET", 0.99)
                          if objective is None else float(objective))
        self.fast_s = (_env_float("MXNET_TPU_TORCH_ALERT_BURN_FAST_S", 60.0)
                       if fast_s is None else float(fast_s))
        self.slow_s = (_env_float("MXNET_TPU_TORCH_ALERT_BURN_SLOW_S", 300.0)
                       if slow_s is None else float(slow_s))
        self.factor = (_env_float("MXNET_TPU_TORCH_ALERT_BURN_FACTOR", 4.0)
                       if factor is None else float(factor))
        kw.setdefault("span_names", ("serve.request",))
        kw.setdefault("window_s", self.slow_s)
        super().__init__(id, **kw)

    def _burn(self, ctx, window_s):
        num = ctx.windowed(self.group, self.num_key, window_s)
        den = ctx.windowed(self.group, self.den_key, window_s)
        if den <= 0:
            return 0.0, num, den
        budget = max(1e-9, 1.0 - self.objective)
        return (num / den) / budget, num, den

    def check(self, ctx):
        fast, fnum, fden = self._burn(ctx, self.fast_s)
        slow, snum, sden = self._burn(ctx, self.slow_s)
        breached = fast >= self.factor and slow >= self.factor
        evidence = {
            "objective": self.objective, "burn_factor": self.factor,
            "windows": {
                "fast": {"window_s": self.fast_s, "burn": round(fast, 3),
                         self.num_key: fnum, self.den_key: fden},
                "slow": {"window_s": self.slow_s, "burn": round(slow, 3),
                         self.num_key: snum, self.den_key: sden},
            },
        }
        return breached, evidence


class ThresholdRule(AlertRule):
    """Live threshold probe: ``value_fn(ctx) -> (value, detail)`` read
    against ``threshold`` with comparator ``op`` (one of ``>`` ``>=``
    ``<`` ``<=``). ``value=None`` means no data — never a breach."""

    _OPS = {">": lambda v, t: v > t, ">=": lambda v, t: v >= t,
            "<": lambda v, t: v < t, "<=": lambda v, t: v <= t}

    def __init__(self, id, value_fn, op, threshold, **kw):
        super().__init__(id, **kw)
        self.value_fn = value_fn
        self.op = op
        self.threshold = threshold

    def check(self, ctx):
        value, detail = self.value_fn(ctx)
        if value is None:
            return False, None
        breached = self._OPS[self.op](value, self.threshold)
        evidence = {"value": value, "op": self.op,
                    "threshold": self.threshold}
        if detail:
            evidence.update(detail)
        return breached, evidence


class StepTimeDriftRule(AlertRule):
    """Rolling median/MAD drift detector on training-step wall time: it
    ingests every new step-root span from the trace ring (tracing must be
    on), and breaches when a step lands beyond ``median + k*1.4826*MAD``
    (and at least twice the median) with ``min_n`` clean samples banked.
    Outliers stay out of the baseline. The ``step_time_anomaly`` fault
    inflates each ingested duration."""

    STEP_ROOTS = ("train.step", "train.sharded_step",
                  "train.captured_step")

    def __init__(self, id, k=None, min_n=8, window_n=64, **kw):
        kw.setdefault("span_names", self.STEP_ROOTS)
        super().__init__(id, **kw)
        self.k = _env_float("MXNET_TPU_TORCH_ALERT_MAD_K", 6.0) \
            if k is None else float(k)
        self.min_n = int(min_n)
        self.durs = deque(maxlen=int(window_n))
        self.last_t0 = 0

    def _new_durations(self):
        from . import trace as _trace
        from ..resilience import faults

        out = []
        high = self.last_t0
        for s in _trace.spans():
            if s["name"] not in self.STEP_ROOTS or \
                    s["t0_ns"] <= self.last_t0:
                continue
            high = max(high, s["t0_ns"])
            # a numerics-sampled step pays the tap by design
            if (s.get("attrs") or {}).get("numerics_sampled"):
                continue
            out.append(faults.maybe_step_time_anomaly(s["dur_ns"]))
        self.last_t0 = high
        return out

    @staticmethod
    def _median(values):
        vals = sorted(values)
        n = len(vals)
        mid = n // 2
        return vals[mid] if n % 2 else (vals[mid - 1] + vals[mid]) / 2.0

    def check(self, ctx):
        worst = None
        for dur in self._new_durations():
            if len(self.durs) >= self.min_n:
                med = self._median(self.durs)
                mad = self._median([abs(d - med) for d in self.durs])
                limit = max(med + self.k * max(1.4826 * mad, 0.05 * med),
                            2.0 * med)
                if dur > limit:
                    if worst is None or dur > worst["dur_ns"]:
                        worst = {"dur_ns": dur, "limit_ns": limit,
                                 "median_ns": med, "mad_ns": mad}
                    continue
            self.durs.append(dur)
        if worst is None:
            return False, None
        keys = sorted(k for k, e in _perf.ledger().items()
                      if not str(e.get("label", "")).startswith("serving"))
        worst.update(k=self.k, n=len(self.durs), ledger_keys=keys)
        return True, worst


class PerfLedgerDropRule(AlertRule):
    """Device-time / MFU regression against each perf-ledger entry's own
    slow EWMA (device timing must be on): breaches when ``device_ms``
    rises, or ``mfu`` falls, beyond ``tolerance`` of the baseline."""

    def __init__(self, id, tolerance=None, min_calls=5, alpha=0.05, **kw):
        kw.setdefault("span_names", ("perf.device_execute",))
        super().__init__(id, **kw)
        self.tolerance = _env_float("MXNET_TPU_TORCH_ALERT_PERF_TOL", 0.5) \
            if tolerance is None else float(tolerance)
        self.min_calls = int(min_calls)
        self.alpha = float(alpha)
        self.baselines: dict = {}

    def check(self, ctx):
        regressed = {}
        live = set()
        for key, e in _perf.device_timed_entries(self.min_calls).items():
            live.add(key)
            base = self.baselines.get(key)
            if base is None:
                self.baselines[key] = {"device_ms": e["device_ms"],
                                       "mfu": e.get("mfu")}
                continue
            slow = e["device_ms"] > base["device_ms"] * (1 + self.tolerance)
            mfu_drop = (e.get("mfu") is not None and base.get("mfu")
                        and e["mfu"] < base["mfu"] * (1 - self.tolerance))
            if slow or mfu_drop:
                regressed[key] = {
                    "device_ms": e["device_ms"],
                    "baseline_device_ms": round(base["device_ms"], 4),
                    "mfu": e.get("mfu"), "baseline_mfu": base.get("mfu"),
                    "tolerance": self.tolerance}
                continue
            base["device_ms"] += self.alpha * (e["device_ms"]
                                               - base["device_ms"])
            if e.get("mfu") is not None:
                prev = base.get("mfu") or e["mfu"]
                base["mfu"] = prev + self.alpha * (e["mfu"] - prev)
        for key in list(self.baselines):
            if key not in live:
                del self.baselines[key]
        if not regressed:
            return False, None
        return True, {"regressed": regressed,
                      "ledger_keys": sorted(regressed)}


class CounterSpikeRule(AlertRule):
    """The summed delta of ``keys`` (observation group ``group``) over the
    fast window reaching ``threshold``."""

    def __init__(self, id, group, keys, threshold=None, window_s=None,
                 **kw):
        fast = _env_float("MXNET_TPU_TORCH_ALERT_BURN_FAST_S", 60.0)
        kw.setdefault("window_s", fast if window_s is None else window_s)
        super().__init__(id, **kw)
        self.group = group
        self.keys = tuple(keys)
        self.threshold = _env_float("MXNET_TPU_TORCH_ALERT_SKIP_SPIKE", 3.0) \
            if threshold is None else float(threshold)

    def check(self, ctx):
        per_key = {k: ctx.windowed(self.group, k, self.window_s)
                   for k in self.keys}
        total = sum(per_key.values())
        if total < self.threshold:
            return False, None
        return True, {"window_s": self.window_s, "total": total,
                      "threshold": self.threshold, "by_counter": per_key}


# -------------------------------------------------------- threshold probes

def _probe_breakers(ctx):
    open_cells = []
    saw_fleet = False
    for fleet in ctx.fleets():
        try:
            if getattr(fleet, "_closed", False):
                continue
            for model in fleet.models():
                for r in fleet._sup.replicas(model):
                    saw_fleet = True
                    if r.breaker.is_open:
                        open_cells.append(f"{model}/{r.rid}")
        except Exception:
            continue
    if not saw_fleet:
        return None, None
    return len(open_cells), {"open": sorted(open_cells)}


def _probe_healthy_floor(ctx):
    worst = None
    detail = {}
    for fleet in ctx.fleets():
        try:
            # a close()d fleet lingers in the weakref registry until GC;
            # its replicas are all DEAD by operator intent (shutdown, not
            # sickness) and must never open a healthy-floor incident
            if getattr(fleet, "_closed", False):
                continue
            for model in fleet.models():
                # a replica draining for SCALE left by operator intent,
                # not sickness: it is no longer a fleet member for floor
                # purposes and must never open a healthy-floor incident
                replicas = [r for r in fleet._sup.replicas(model)
                            if not getattr(r, "scale_drain", False)]
                if not replicas:
                    continue
                healthy = sum(1 for r in replicas if r.state == "HEALTHY")
                detail[model] = healthy
                worst = healthy if worst is None else min(worst, healthy)
        except Exception:
            continue
    if worst is None:
        return None, None
    return worst, {"healthy_by_model": detail}


def _probe_input_stall(ctx):
    value = (ctx.input_stall if ctx.input_stall is not None
             else _metrics.update_input_stall())
    # the evidence names where the starving loop's streaming iterators sat
    # (epoch and global cursor, io/stream.py); a lookup, not an import, so
    # the alert path never loads the io package
    detail = None
    stream_mod = sys.modules.get("mxnet_tpu_torch.io.stream")
    if stream_mod is not None:
        positions = stream_mod.live_positions()
        if positions:
            detail = {"stream_positions": positions}
    return value, detail


def _probe_numerics(cond_name):
    """Threshold probe over one numerics-tap condition: None until a tap
    has judged it."""

    def probe(ctx):
        from . import numerics

        cond = numerics.condition(cond_name)
        if cond is None:
            return None, None
        detail = {"since_step": cond.get("since_step"),
                  "snapshot": cond.get("snapshot")}
        detail.update(cond.get("evidence") or {})
        return (1 if cond.get("active") else 0), detail

    return probe


def _probe_pod_hosts(ctx):
    """Dead pod hosts per the watchdog's host liveness tracker: no data
    until this process configures a pod (a one-host run never evaluates a
    host-down alert); the sticky dead set keeps the incident FIRING until
    re-admission (``watchdog.configure_pod`` / ``reset_hosts``)."""
    watchdog = sys.modules.get("mxnet_tpu_torch.resilience.watchdog")
    if watchdog is None:
        return None, None
    snap = watchdog.pod_snapshot()
    if not snap.get("configured"):
        return None, None
    dead = sorted(snap.get("dead_hosts") or ())
    return len(dead), {"dead_hosts": dead, "num_hosts": snap.get("num_hosts"),
                       "coordinator": snap.get("coordinator")}


def _default_rules():
    floor = _env_float("MXNET_TPU_TORCH_ALERT_HEALTHY_FLOOR", 1.0)
    stall_max = _env_float("MXNET_TPU_TORCH_ALERT_STALL_MAX", 0.5)
    return (
        BurnRateRule(
            "slo_deadline_burn", "fleet_deadline_exceeded",
            "fleet_requests",
            description="fleet deadline-miss rate burning the SLO error "
                        "budget in both the fast and slow window"),
        BurnRateRule(
            "slo_shed_burn", "fleet_shed_overloaded", "fleet_requests",
            description="fleet overload-shed rate burning the SLO error "
                        "budget in both the fast and slow window"),
        ThresholdRule(
            "fleet_breaker_open", _probe_breakers, ">=", 1,
            span_names=("serve.request",),
            description="at least one live replica's circuit breaker is "
                        "open (requests are being rerouted around it)"),
        ThresholdRule(
            "fleet_healthy_floor", _probe_healthy_floor, "<", floor,
            span_names=("serve.request",),
            description="a served model has fewer HEALTHY replicas than "
                        "the configured floor"),
        ThresholdRule(
            "input_stall_high", _probe_input_stall, ">", stall_max,
            span_names=("step.data_wait",),
            description="the training loop is input-bound: "
                        "mxnet_tpu_input_stall_fraction over its ceiling"),
        StepTimeDriftRule(
            "step_time_drift",
            description="training-step wall time drifted outside "
                        "median + k*MAD of its recent history"),
        PerfLedgerDropRule(
            "perf_device_regression",
            description="a captured graph's EWMA device time rose (or its "
                        "MFU fell) beyond tolerance of its own baseline"),
        CounterSpikeRule(
            "health_skip_spike", "health",
            ("health_skipped_steps", "sentinel_grad_norm_trips"),
            description="HealthSentinel skips / grad-norm trips spiking "
                        "inside one fast window"),
        ThresholdRule(
            "numerics_nonfinite", _probe_numerics("nonfinite"), ">=", 1,
            span_names=("train.captured_step", "train.sharded_step"),
            description="the numerics tap saw a non-finite value (NaN/Inf "
                        "onset); a numerics snapshot was published"),
        ThresholdRule(
            "numerics_grad_explosion", _probe_numerics("grad_explosion"),
            ">=", 1, span_names=("train.captured_step",
                                 "train.sharded_step"),
            description="the global gradient norm exploded outside "
                        "median + k*MAD of its own clean history"),
        ThresholdRule(
            "numerics_dead_layer", _probe_numerics("dead_layer"), ">=", 1,
            span_names=("train.captured_step", "train.sharded_step"),
            description="a layer's gradients stayed ~0 or fully "
                        "fp16-underflowed for N consecutive samples while "
                        "the rest of the net kept training"),
        BurnRateRule(
            "decode_ttft_burn", "decode_ttft_misses", "decode_sequences",
            group="decode", span_names=("decode.prefill", "decode.admit"),
            description="decode time-to-first-token SLO misses burning "
                        "the error budget in both the fast and slow "
                        "window (TTFT over "
                        "MXNET_TPU_TORCH_DECODE_TTFT_SLO_MS at admission)"),
        ThresholdRule(
            "pod_host_down", _probe_pod_hosts, ">=", 1,
            description="a pod host failure domain is dead: the "
                        "watchdog's liveness layer (beats, pid checks, "
                        "stall blame) marked at least one host dead; "
                        "sticky until re-admission"),
        CounterSpikeRule(
            "sdc_detected", "integrity",
            ("integrity_audit_mismatches", "integrity_selftest_failures",
             "integrity_serving_failures", "integrity_ckpt_mismatches"),
            threshold=1,
            description="silent data corruption caught: a shadow replay "
                        "audit mismatch, a failed device self-test, a "
                        "lying serving replica, or a checkpoint whose "
                        "values disagree with its fingerprint"),
    )


def register_rule(rule):
    """Register (or replace) one rule; returns it. Default rules are
    registered at import — :func:`reset` restores exactly that set."""
    with _LOCK:
        _RULES[rule.id] = rule
    return rule


def unregister_rule(rule_id):
    with _LOCK:
        return _RULES.pop(rule_id, None) is not None


def rules():
    with _LOCK:
        return dict(_RULES)


def get_rule(rule_id):
    with _LOCK:
        return _RULES.get(rule_id)


# ---------------------------------------------------------------- incidents

class Incident(dict):
    """One correlated diagnosis bundle (a plain dict subclass so it
    JSON-serializes as-is). Keys: ``id``, ``rule``, ``severity``,
    ``description``, ``status`` (open|resolved), ``opened_t`` /
    ``opened_now`` / ``resolved_t`` / ``resolved_now``, ``evidence``
    (the rule's window math), ``flight`` (the recorder slice covering
    the evidence window), ``exemplars`` (the K slowest matching span
    trees) and ``fleet`` (replica/breaker states at open time)."""


def _exemplar_trees(span_names, k):
    """The ``k`` slowest root spans matching ``span_names`` (all roots
    when empty), each expanded to its full tree (every ring record
    sharing the trace id). Trees are slowest-first and each tree lists
    its ROOT record first (descendants follow in ring order — children
    end before their parents, so raw ring order buries the root)."""
    from . import trace as _trace

    recs = _trace.spans()
    roots = _trace.roots(names=span_names)
    roots.sort(key=lambda r: r["dur_ns"], reverse=True)
    trees = []
    for root in roots[:k]:
        rest = [r for r in recs
                if r["trace"] == root["trace"] and r is not root]
        trees.append([root] + rest)
    return trees


def _fleet_states():
    out = []
    try:
        import sys

        serving = sys.modules.get("mxnet_tpu_torch.serving")
        if serving is None:
            return out
        for fleet in serving._live_fleets():
            try:
                for model in fleet.models():
                    for r in fleet._sup.replicas(model):
                        out.append({"model": model, "replica": r.rid,
                                    "state": getattr(r, "display_state",
                                                     r.state),
                                    "breaker_open": bool(r.breaker.is_open)})
            except Exception:
                continue
    except Exception:
        pass
    return out


def _open_incident(rule, evidence, ctx):
    since = ctx.seq_at(rule.window_s)
    flight_slice = _flight.events(since_seq=since)
    k = max(1, _env_int("MXNET_TPU_TORCH_ALERT_EXEMPLARS", 3))
    trees = _exemplar_trees(rule.span_names, k)
    inc = Incident(
        id=f"inc-{next(_INCIDENT_IDS)}",
        rule=rule.id,
        severity=rule.severity,
        description=rule.description,
        status="open",
        opened_t=time.time(),
        opened_now=ctx.now,
        resolved_t=None,
        resolved_now=None,
        evidence=evidence or {},
        flight=flight_slice,
        exemplars=trees,
        fleet=_fleet_states(),
    )
    with _LOCK:
        _INCIDENTS.append(inc)
    _STATS["alert_incidents_opened"] += 1
    return inc


def incidents(status=None, limit=None):
    """Recorded incidents, oldest first; optionally filtered by
    ``status`` (``open``/``resolved``) and truncated to the newest
    ``limit``. Entries are live dicts of a bounded ring — treat as
    read-only snapshots."""
    with _LOCK:
        out = list(_INCIDENTS)
    if status is not None:
        out = [i for i in out if i["status"] == status]
    if limit is not None and limit >= 0:
        out = out[-limit:] if limit else []  # -0: would slice ALL
    return out


def open_incidents():
    return incidents(status="open")


# ------------------------------------------------------------------- engine

def _advance(rule, breached, evidence, ctx):
    """One state-machine step for one rule; returns a transition string
    (``FIRING``/``RESOLVED``) or None. Runs outside the module lock
    (incident assembly reads other subsystems); per-rule state is only
    touched from the engine, which is serialized by ``_EVAL_LOCK``."""
    now = ctx.now
    if breached:
        rule.last_breach = now
        rule.last_evidence = evidence
        if rule.state == "OK":
            rule.pending_since = now
            rule.state = "PENDING"
        if rule.state == "PENDING" and \
                now - rule.pending_since >= rule.hold_s:
            rule.state = "FIRING"
            inc = _open_incident(rule, evidence, ctx)
            rule.incident_id = inc["id"]
            _flight.record("alert", rule=rule.id, state="FIRING",
                           severity=rule.severity, incident=inc["id"])
            _STATS["alert_transitions"] += 1
            return "FIRING"
        return None
    if rule.state == "PENDING":
        rule.state = "OK"
        rule.pending_since = None
        return None
    if rule.state == "FIRING" and \
            now - (rule.last_breach or now) >= rule.cooldown_s:
        rule.state = "OK"
        rule.pending_since = None
        incident_id = rule.incident_id
        rule.incident_id = None
        with _LOCK:
            for inc in _INCIDENTS:
                if inc["id"] == incident_id:
                    inc["status"] = "resolved"
                    inc["resolved_t"] = time.time()
                    inc["resolved_now"] = now
        _flight.record("alert", rule=rule.id, state="RESOLVED",
                       incident=incident_id)
        _STATS["alert_transitions"] += 1
        _STATS["alert_incidents_resolved"] += 1
        return "RESOLVED"
    return None


_EVAL_LOCK = threading.Lock()


def evaluate(now=None, force=False, slo=None, input_stall=None):
    """Run every registered rule once against a fresh observation.
    ``now`` (monotonic seconds) defaults to ``time.monotonic()`` —
    tests and drills pass a synthetic clock to drive windows and
    hold/cooldown deterministically. ``slo`` reuses the
    ``slo_counters()`` view ``update_derived`` already took this tick, so
    gauges and rules judge the same numbers. Returns
    ``{rule_id: transition}`` for the rules that transitioned this
    round, or None when alerting is disabled (pass ``force=True`` to
    evaluate anyway)."""
    if not _ENABLED and not force:
        return None
    if now is None:
        now = time.monotonic()
    with _EVAL_LOCK:
        obs = {"now": now, "seq": _flight.last_seq(),
               "slo": _slo_counters() if slo is None else slo,
               "decode": _decode_counters(),
               "health": _health_counters(),
               "integrity": _integrity_counters()}
        with _LOCK:
            # a clock that moved backwards (a synthetic test clock after
            # a real-clock run, or vice versa) restarts the window
            # history AND re-bases per-rule timestamps into the new
            # clock domain — a rule left FIRING under the old clock
            # would otherwise compare `now - last_breach` across
            # domains and never satisfy its cooldown (stuck open)
            if _HISTORY and _HISTORY[-1]["now"] > now:
                _HISTORY.clear()
                for r in _RULES.values():
                    if r.last_breach is not None and r.last_breach > now:
                        r.last_breach = now
                    if r.pending_since is not None and \
                            r.pending_since > now:
                        r.pending_since = now
            _HISTORY.append(obs)
            history = list(_HISTORY)
            current = list(_RULES.values())
        ctx = _EvalContext(now, obs, history, input_stall)
        transitions = {}
        for rule in current:
            try:
                breached, evidence = rule.check(ctx)
            except Exception:
                continue  # one broken rule must never kill the exporter
            t = _advance(rule, breached, evidence, ctx)
            if t:
                transitions[rule.id] = t
        _STATS["alert_evaluations"] += 1
        return transitions


def maybe_evaluate(slo=None, input_stall=None):
    """The exporter-cadence hook (``metrics.update_derived`` calls it,
    passing its already-derived ``slo_counters()`` view): one global
    check when disabled, a full :func:`evaluate` otherwise, rate-limited
    to at most one evaluation per ``MXNET_TPU_TORCH_ALERT_EVAL_S`` seconds
    (0 = every exporter tick). The
    rate limiter keeps its OWN real-monotonic bookkeeping — a drill's
    synthetic evaluation clock must never suppress real exporter
    ticks."""
    global _LAST_TICK
    if not _ENABLED:
        return None
    min_s = _env_float("MXNET_TPU_TORCH_ALERT_EVAL_S", 0.0)
    real = time.monotonic()
    if min_s > 0 and _LAST_TICK is not None and real - _LAST_TICK < min_s:
        return None
    out = evaluate(slo=slo, input_stall=input_stall)
    _LAST_TICK = real
    return out


def snapshot():
    """The ``observability.dump()`` section: per-rule states plus the
    open-incident count (full incidents ride in ``dump()["incidents"]``)."""
    with _LOCK:
        rules_snap = [r.describe() for r in _RULES.values()]
        n_open = sum(1 for i in _INCIDENTS if i["status"] == "open")
    return {"enabled": _ENABLED, "rules": rules_snap,
            "open_incidents": n_open}


def reset():
    """Restore the default rule set and clear all dynamic state
    (history, incidents, per-rule machines) — tests and drills call
    this between cases."""
    global _LAST_TICK
    with _EVAL_LOCK:
        with _LOCK:
            _RULES.clear()
            _HISTORY.clear()
            _INCIDENTS.clear()
        for rule in _default_rules():
            register_rule(rule)
        _LAST_TICK = None


for _rule in _default_rules():
    register_rule(_rule)
del _rule

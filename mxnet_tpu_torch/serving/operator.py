"""The fleet operates itself (port of ``mxnet_tpu/serving/operator.py``).

- :class:`Autoscaler` scales each ``model@variant`` replica group from two
  signals: the outstanding requests per healthy replica and the alert
  engine's open SLO-burn incidents (``slo_deadline_burn``,
  ``slo_shed_burn``). Distinct up / down thresholds and per-direction
  cooldowns give the loop hysteresis, so a flapping signal (fault
  ``autoscale_flap``) causes at most one scale event per cooldown.
  Scale-down drains through ``DRAINING(scale)``; scale-up admits a
  replica only after its buckets are captured and a probe passes.
- :class:`RolloutManager` rolls candidate weights out through one canary
  replica, which must pass the health gate (finite outputs on the eval
  batch), the accuracy gate (top-1 agreement with the prior weights at
  ``MXNET_TPU_TORCH_ROLLOUT_MIN_AGREEMENT``), the latency gate (canary
  p50 within ``MXNET_TPU_TORCH_ROLLOUT_MAX_LATENCY_X`` of the baseline
  over ``MXNET_TPU_TORCH_ROLLOUT_CANARY_CALLS`` calls) and, for a decode
  predictor, the token-parity and TTFT gates, before every other replica
  takes the weights. A failed gate restores the canary's prior weights
  before returning: a bad push (``rollout_bad_weights``) or a slow one
  (``canary_slo_regression``) costs no client an error.

Weights move by ``swap_params``: copies into the bound cells under the
lock the bucket graphs replay under, so no graph is captured again.
``rollout_schedule`` needs the autotune schedule tables (``tune/``),
which the port does not have: it raises, naming ROADMAP Queue 1 item 13.

Every decision is a flight event (kind ``operator``) and a counter in
``serving.stats()``; every rollout is one span tree rooted at
``rollout.weights``.
"""
from __future__ import annotations

import itertools
import os
import threading
import time

from ..base import MXNetError
from ..observability import flight as _obs_flight
from ..observability import trace as _trace
from ..resilience import faults as _faults
from . import _STATS
from .fleet import _variant_key


def _env_float(name, default):
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


# ------------------------------------------------------------- autoscaler

class Autoscaler:
    """SLO-burn + queue-depth driven replica autoscaling for one Fleet.

    Synchronous core: ``evaluate()`` reads the signals once and issues
    at most one scaling action per replica group, returning the
    decision records. ``start()`` runs that loop on a daemon thread
    every ``interval_s``. Decisions:

    - scale UP when an SLO-burn incident (``slo_deadline_burn`` /
      ``slo_shed_burn``) is open for the fleet OR queue depth per
      healthy replica reaches ``up_queue`` — by ``step`` replicas, to
      at most ``max_replicas``.
    - scale DOWN when queue depth is at or under ``down_queue`` AND no
      burn incident is open — by one replica, to at least
      ``min_replicas``. The supervisor drains the least-loaded member
      (``DRAINING(scale)``): in-flight requests complete, and the
      leaver never counts against the alert engine's healthy floor.
    - HOLD otherwise — still a recorded decision (flight event kind
      ``operator`` + the ``fleet_scale_hold`` counter), so a quiet
      control loop is distinguishable from a dead one.

    Hysteresis: the up/down thresholds are distinct, and each direction
    has its own ``cooldown_s`` window per group — additionally a
    scale-DOWN is refused inside the cooldown window of the last
    scale-UP, so an oscillating signal (chaos ``autoscale_flap``)
    causes at most one scale event per cooldown period instead of
    thrashing the fleet.
    """

    def __init__(self, fleet, *, min_replicas=None, max_replicas=None,
                 up_queue=None, down_queue=None, cooldown_s=None,
                 step=None, interval_s=None, clock=time.monotonic):
        self._fleet = fleet
        self.min_replicas = max(1, int(
            min_replicas if min_replicas is not None
            else _env_int("MXNET_TPU_TORCH_FLEET_MIN_REPLICAS", 1)))
        self.max_replicas = int(
            max_replicas if max_replicas is not None
            else _env_int("MXNET_TPU_TORCH_FLEET_MAX_REPLICAS", 8))
        self.up_queue = float(
            up_queue if up_queue is not None
            else _env_float("MXNET_TPU_TORCH_FLEET_SCALE_UP_QUEUE", 8.0))
        self.down_queue = float(
            down_queue if down_queue is not None
            else _env_float("MXNET_TPU_TORCH_FLEET_SCALE_DOWN_QUEUE", 1.0))
        self.cooldown_s = float(
            cooldown_s if cooldown_s is not None
            else _env_float("MXNET_TPU_TORCH_FLEET_SCALE_COOLDOWN_S", 30.0))
        self.step = max(1, int(
            step if step is not None
            else _env_int("MXNET_TPU_TORCH_FLEET_SCALE_STEP", 1)))
        self.interval_s = float(
            interval_s if interval_s is not None
            else _env_float("MXNET_TPU_TORCH_FLEET_SCALE_INTERVAL_S", 2.0))
        if self.down_queue >= self.up_queue:
            raise MXNetError(
                f"Autoscaler needs down_queue < up_queue for hysteresis, "
                f"got {self.down_queue} >= {self.up_queue}")
        self._clock = clock
        self._last = {}            # (group, "up"|"down") -> decision time
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    # ------------------------------------------------------------- signals
    def _burning(self, rule_ids=("slo_deadline_burn", "slo_shed_burn")):
        """True when the alert engine holds an OPEN SLO-burn incident —
        the operator consumes the engine's multi-window judgement
        instead of re-deriving burn math from raw counters."""
        from ..observability import alerts as _alerts

        try:
            for inc in _alerts.open_incidents():
                if inc.get("rule") in rule_ids:
                    return True
        except Exception:
            pass
        return False

    def signals(self, group):
        """Measured load signals for one replica group: queue depth per
        healthy replica (router-outstanding, the same number the
        balancer minimizes) and the in-fleet member count."""
        members = [r for r in self._fleet._sup.replicas(group)
                   if not r.scale_drain]
        healthy = [r for r in members if r.state == "HEALTHY"]
        queued = sum(r.outstanding for r in healthy)
        depth = queued / max(1, len(healthy))
        return {"members": len(members), "healthy": len(healthy),
                "queue_per_replica": depth}

    # ------------------------------------------------------------ decisions
    def _cooled(self, now, group, direction):
        t = self._last.get((group, direction))
        return t is None or (now - t) >= self.cooldown_s

    def evaluate(self, now=None):
        """One control-loop pass over every replica group; returns the
        decision records (also flight events + counters). ``now`` takes
        a synthetic clock for deterministic tests."""
        now = self._clock() if now is None else now
        burning = self._burning()
        decisions = []
        with self._lock:
            for group in self._fleet.models():
                sig = self.signals(group)
                depth = _faults.maybe_autoscale_flap(
                    sig["queue_per_replica"])
                count = sig["members"]
                action, target = "hold", count
                if ((burning or depth >= self.up_queue)
                        and count < self.max_replicas
                        and self._cooled(now, group, "up")):
                    action = "scale_up"
                    target = min(self.max_replicas, count + self.step)
                elif (not burning and depth <= self.down_queue
                        and count > self.min_replicas
                        and self._cooled(now, group, "up")
                        and self._cooled(now, group, "down")):
                    action = "scale_down"
                    target = max(self.min_replicas, count - 1)
                decision = {"group": group, "action": action,
                            "from": count, "to": target,
                            "queue_per_replica": round(float(depth), 3),
                            "slo_burn": burning}
                if action == "hold":
                    _STATS["fleet_scale_hold"] += 1
                else:
                    self._last[(group, "up" if action == "scale_up"
                                else "down")] = now
                _obs_flight.record("operator", decide=action, model=group,
                                   replicas=count, target=target,
                                   queue=round(float(depth), 3),
                                   slo_burn=burning)
                if action != "hold":
                    try:
                        decision["to"] = self._fleet.scale_to(
                            target, model=group)
                    except Exception as e:
                        decision["error"] = str(e)
                        _obs_flight.record("operator", decide="error",
                                           model=group, error=str(e))
                decisions.append(decision)
        return decisions

    # ----------------------------------------------------------- background
    def start(self):
        """Run the control loop on a daemon thread every
        ``interval_s``; idempotent."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="mxnet-torch-autoscaler",
                daemon=True)
            self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception:
                # the control loop must survive a transient read racing
                # fleet teardown; the next tick sees consistent state
                pass

    def stop(self, timeout=5.0):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    close = stop


# --------------------------------------------------------------- rollouts

class RolloutManager:
    """Canaried zero-downtime artifact rollout for one replica group.

    Thread-mode fleets only: a live swap needs the predictor in this
    process (process replicas rebuild through their factory instead). ``eval_batch`` — one representative input batch (array or
    dict name -> array, WITH batch axis) — drives all three gates; give
    it at construction or per call.
    """

    def __init__(self, fleet, *, model="default", variant=None,
                 eval_batch=None, min_agreement=None, canary_calls=None,
                 max_latency_x=None):
        self._fleet = fleet
        self._group = _variant_key(model, variant)
        self._eval_batch = eval_batch
        self.min_agreement = float(
            min_agreement if min_agreement is not None
            else _env_float("MXNET_TPU_TORCH_ROLLOUT_MIN_AGREEMENT", 0.99))
        self.canary_calls = max(1, int(
            canary_calls if canary_calls is not None
            else _env_int("MXNET_TPU_TORCH_ROLLOUT_CANARY_CALLS", 16)))
        self.max_latency_x = float(
            max_latency_x if max_latency_x is not None
            else _env_float("MXNET_TPU_TORCH_ROLLOUT_MAX_LATENCY_X", 3.0))
        self._seq = itertools.count(1)
        self._lock = threading.Lock()

    # -------------------------------------------------------------- helpers
    def _members(self):
        if self._fleet.mode != "thread":
            raise MXNetError(
                "rollout needs a thread-mode fleet (process replicas "
                "own their predictor in a child; roll out by updating "
                "the factory artifact and restarting instead)")
        members = sorted(
            (r for r in self._fleet._sup.replicas(self._group)
             if r.state == "HEALTHY" and not r.scale_drain),
            key=lambda r: r.rid)
        if not members:
            raise MXNetError(
                f"rollout: no HEALTHY replica in group "
                f"'{self._group}' to canary on")
        return members

    def _batch(self, eval_batch):
        batch = eval_batch if eval_batch is not None else self._eval_batch
        if batch is None:
            raise MXNetError(
                "rollout needs an eval_batch (constructor or call) to "
                "drive the canary gates")
        return batch

    @staticmethod
    def _finite(outs):
        from ..resilience.sentinel import all_finite

        return all_finite(outs)

    @staticmethod
    def _agreement(cand, ref):
        """Accuracy gate: top-1 agreement between candidate and reference
        outputs when the trailing axis is a class axis; the element-wise
        closeness fraction otherwise."""
        import numpy as np

        a, b = _host(cand[0]), _host(ref[0])
        if a.shape != b.shape:
            return 0.0
        if a.ndim >= 2 and a.shape[-1] > 1:
            return float(np.mean(np.argmax(a, axis=-1)
                                 == np.argmax(b, axis=-1)))
        return float(np.mean(np.isclose(a, b, rtol=1e-2, atol=1e-5)))

    def _measure_p50(self, pred, batch, faulted=False):
        """Canary latency window: p50 over ``canary_calls`` direct
        predictor calls. ``faulted`` routes each sample through the
        ``canary_slo_regression`` chaos hook (candidate windows only —
        the baseline must stay honest)."""
        lat = []
        for _ in range(self.canary_calls):
            t0 = time.perf_counter()
            pred.predict_raw(batch)
            dt = time.perf_counter() - t0
            if faulted:
                dt = _faults.maybe_canary_slo_regression(dt)
            lat.append(dt)
        lat.sort()
        return lat[len(lat) // 2]

    @staticmethod
    def _canary_span(replica):
        return _trace.span("rollout.canary", replica=replica.rid)

    def _latency_gate(self, pred, batch, base_p50):
        """The shared latency gate: candidate p50 must stay within
        ``max_latency_x`` of the pre-swap baseline. Returns
        ``(gate, detail, p50)`` with ``gate`` None on pass."""
        with _trace.span("rollout.gate.latency"):
            p50 = self._measure_p50(pred, batch, faulted=True)
            ceil = max(base_p50, 1e-6) * self.max_latency_x
            if p50 > ceil:
                return ("latency",
                        f"canary p50 {p50 * 1e6:.0f}us > "
                        f"{self.max_latency_x}x baseline "
                        f"{base_p50 * 1e6:.0f}us", p50)
        return None, None, p50

    # ------------------------------------------------- decode canary gates
    @staticmethod
    def _decode_capable(pred):
        """Decode predictors duck-type ``greedy_decode``; fixed-shape
        predictors get the classic three gates only."""
        return hasattr(pred, "greedy_decode")

    @staticmethod
    def _decode_probe(pred):
        """Deterministic canary prompt + decode length, sized to the
        predictor's context window so the probe never trips the
        max_len eviction path."""
        spec = pred._spec
        prompt = [(i * 7 + 3) % spec["vocab"] for i in range(6)]
        return prompt, max(1, min(6, spec["max_len"] - len(prompt) - 1))

    def _measure_ttft(self, pred, prompt):
        """p50 time-to-first-token over a quarter canary window: each
        sample is one bucketed prefill + first-token emit
        (``greedy_decode`` of a single token) — the decode cost a real
        admission pays before it can stream anything."""
        lat = []
        for _ in range(max(1, self.canary_calls // 4)):
            t0 = time.perf_counter()
            pred.greedy_decode(list(prompt), 1)
            lat.append(time.perf_counter() - t0)
        lat.sort()
        return lat[len(lat) // 2]

    def _token_parity(self, pred, prompt, n):
        """Greedy-decode the candidate through the PAGED path and check
        every token against the argmax of the predictor's own flat
        full-context forward on the growing context. Internal
        consistency of one artifact across its two executable families
        — a candidate whose paged KV path diverges from its probe
        forward must not serve streams. Returns None on parity, else
        ``(index, total, got, want)`` for the first mismatch."""
        import numpy as np

        toks = pred.greedy_decode(list(prompt), n)
        ctx = list(prompt)
        for i, t in enumerate(toks):
            outs, _ = pred.predict_raw(np.asarray([ctx], np.int32))
            want = int(np.argmax(_host(outs[0])[0, -1]))
            if int(t) != want:
                return i, len(toks), int(t), want
            ctx.append(want)
        return None

    def _decode_gates(self, pred, base_ttft):
        """The two extra gates a decode-capable canary must pass after
        the classic three: token parity, then TTFT p50 within
        ``max_latency_x`` of the pre-swap baseline. Returns
        ``(gate, detail, ttft)`` with ``gate`` None on pass."""
        prompt, n = self._decode_probe(pred)
        with _trace.span("rollout.gate.decode_parity"):
            mismatch = self._token_parity(pred, prompt, n)
            if mismatch is not None:
                i, total, got, want = mismatch
                return ("decode_parity",
                        f"paged token {i}/{total} = {got} but flat "
                        f"argmax = {want}", None)
        with _trace.span("rollout.gate.decode_ttft"):
            ttft = self._measure_ttft(pred, prompt)
            ceil = max(base_ttft, 1e-6) * self.max_latency_x
            if ttft > ceil:
                return ("decode_ttft",
                        f"canary TTFT p50 {ttft * 1e6:.0f}us > "
                        f"{self.max_latency_x}x baseline "
                        f"{base_ttft * 1e6:.0f}us", ttft)
        return None, None, ttft

    @staticmethod
    def _rollback_span(gate):
        return _trace.span("rollout.rollback", gate=gate)

    @staticmethod
    def _promote_span(replicas):
        return _trace.span("rollout.promote", replicas=replicas)

    def _decide(self, span, kind, rollout_id, action, **fields):
        key = {"promote": "rollout_promotions",
               "rollback": "rollout_rollbacks",
               "hold": "rollout_holds"}[action]
        _STATS[key] += 1
        span.set(outcome=action, **fields)
        _obs_flight.record("operator", decide=action, rollout=rollout_id,
                           artifact=kind, model=self._group, **fields)
        out = {"action": action, "rollout_id": rollout_id,
               "artifact": kind, "group": self._group}
        out.update(fields)
        return out

    # -------------------------------------------------------------- weights
    def rollout_weights(self, params, eval_batch=None, reference=None):
        """Canary-then-promote one candidate params artifact (dict
        ``name``/``arg:name``/``aux:name`` -> array or tensor, or a
        ``.params`` path). Returns the decision record: ``action`` is ``promote``
        or ``rollback`` (+ ``gate``/``detail`` naming the failed
        gate). ``reference`` optionally supplies the accuracy gate's
        expected outputs; default is the prior artifact's own outputs
        on the eval batch — right for a weight refresh that must not
        shift behavior, too strict for an intentional retrain (pass the
        new reference outputs then)."""
        batch = self._batch(eval_batch)
        with self._lock:
            rollout_id = f"weights-{next(self._seq)}"
            members = self._members()
            canary, rest = members[0], members[1:]
            with _trace.span("rollout.weights", rollout=rollout_id,
                             model=self._group, canary=canary.rid,
                             replicas=len(members)) as root:
                params = _faults.maybe_rollout_bad_weights(params)
                # Bind the canary's predictor OBJECT once: while the
                # candidate serves live traffic, a bad artifact can trip
                # the sentinel/breaker and the supervisor may recycle
                # the canary replica mid-rollout (replica.predictor
                # becomes None, then a fresh build). Gates and rollback
                # keep operating on the bound object — and a restart
                # rebuilds the pristine factory artifact, so unswapping
                # an orphaned predictor is harmless either way.
                pred = canary.predictor
                with self._canary_span(canary):
                    base_outs, _ = pred.predict_raw(batch)
                    base_p50 = self._measure_p50(pred, batch)
                    base_ttft = None
                    if self._decode_capable(pred):
                        base_ttft = self._measure_ttft(
                            pred, self._decode_probe(pred)[0])
                    try:
                        prev = pred.swap_params(params)
                    except MXNetError as e:
                        # rejected before any cell flipped: the prior
                        # artifact never left, but the push failed
                        return self._decide(
                            root, "weights", rollout_id, "rollback",
                            gate="swap_validation", detail=str(e))
                gate, detail = None, None
                with _trace.span("rollout.gate.health"):
                    cand_outs, _ = pred.predict_raw(batch)
                    if not self._finite(cand_outs):
                        gate, detail = "health", "nonfinite canary outputs"
                agreement = None
                if gate is None:
                    with _trace.span("rollout.gate.accuracy"):
                        ref = reference if reference is not None \
                            else base_outs
                        agreement = self._agreement(cand_outs, ref)
                        if agreement < self.min_agreement:
                            gate = "accuracy"
                            detail = (f"top-1 agreement {agreement:.4f} < "
                                      f"{self.min_agreement}")
                p50 = None
                if gate is None:
                    gate, detail, p50 = self._latency_gate(
                        pred, batch, base_p50)
                ttft = None
                if gate is None and base_ttft is not None:
                    gate, detail, ttft = self._decode_gates(
                        pred, base_ttft)
                if gate is not None:
                    with self._rollback_span(gate):
                        pred.swap_params(prev)
                    return self._decide(
                        root, "weights", rollout_id, "rollback",
                        gate=gate, detail=detail)
                with self._promote_span(len(rest) + 1):
                    for r in rest:
                        rp = r.predictor
                        if rp is None:
                            # recycled mid-promote: the restart rebuilds
                            # the factory artifact; the next rollout of
                            # the same candidate converges it
                            continue
                        rp.swap_params(params)
                fields = {"agreement": round(agreement, 4),
                          "canary_p50_us": int(p50 * 1e6),
                          "baseline_p50_us": int(base_p50 * 1e6)}
                if ttft is not None:
                    fields["canary_ttft_us"] = int(ttft * 1e6)
                    fields["baseline_ttft_us"] = int(base_ttft * 1e6)
                return self._decide(
                    root, "weights", rollout_id, "promote", **fields)

    # ------------------------------------------------------------- schedule
    def rollout_schedule(self, table_path, eval_batch=None, reason=None):
        """Canary-then-promote an autotune schedule table: needs the
        autotuner's tables (``tune/``), which the port does not have."""
        raise MXNetError(
            "RolloutManager.rollout_schedule needs the autotune schedule "
            "tables (tune/), not ported yet (ROADMAP Queue 1 item 13)")


def _host(o):
    """An output (tensor or array) as a float numpy array."""
    import numpy as np

    if hasattr(o, "detach"):
        return o.detach().float().cpu().numpy()
    return np.asarray(o)

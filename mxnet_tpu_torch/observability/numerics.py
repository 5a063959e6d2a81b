"""In-graph numerics telemetry for the captured training step (port of
``mxnet_tpu/observability/numerics.py``).

- **NumericsTap** — attached to a ``capture.CapturedTrainerStep``, a
  ``capture.CapturedShardedStep`` or a ``parallel.ShardedTrainer``
  (``attach_numerics``), it plans one statistics row per tapped tensor
  (per-parameter gradient, weight and optimizer update) and the step
  computes the whole ``(rows, stats)`` float32 matrix on the device as one
  more output. The cadence picks between two programs per signature, with
  and without the tap (on a CUDA graph: two graphs, chosen on the host
  each step), and the stat selection is a column mask read from a device
  slot, so changing either never captures again.
- **Stat columns** (``NUMERICS_STATS``): ``l2``, ``maxabs``,
  ``nonfinite`` (NaN/Inf count), ``underflow`` (fraction of nonzero
  elements that flush to zero in fp16), ``ratio`` (update-to-param norm
  ratio; update rows only).
- **Emission** — each sampled step lands in the metrics registry
  (``mxnet_tpu_numerics_stat``, ``mxnet_tpu_numerics_grad_norm``), the
  flight recorder (kind ``numerics``) and a bounded history ring.
- **Divergence conditions** — ``nonfinite``, ``grad_explosion`` (global
  grad norm outside median + k*1.4826*MAD of its clean history) and
  ``dead_layer`` (a gradient ~0 or fully fp16-underflowed for N samples
  while the rest trains). Turning active writes a numerics snapshot
  (parameters, optimizer state, the batch; :func:`load_snapshot` reads it)
  and surfaces through the ``numerics_*`` alert rules.
- **Policy** — ``MXNET_TPU_TORCH_NONFINITE_POLICY``: ``halt`` raises
  :class:`NumericsDivergenceError` when a sampled step shows a non-finite
  value; ``skip`` and ``record`` observe. The port's step does not gate
  its weight write in the graph (ROADMAP Queue 3): the judgement comes
  from the sampled matrix, after the update.

Knobs: ``MXNET_TPU_TORCH_NUMERICS``, ``..._NUMERICS_INTERVAL``,
``..._NUMERICS_STATS``, ``..._NUMERICS_SNAPSHOT_DIR``,
``..._NUMERICS_SNAPSHOT_KEEP``, ``..._NONFINITE_POLICY``.
"""
from __future__ import annotations

import json
import os
import threading
import time

from collections import deque

import numpy as np

from . import _STATS
from . import flight as _flight
from . import metrics as _metrics
from . import trace as _trace

__all__ = ["NumericsTap", "NumericsDivergenceError", "NUMERICS_STATS",
           "NUMERICS_CONDITIONS", "POLICIES", "default_tap", "condition",
           "conditions", "history", "last_snapshot", "snapshots",
           "snapshot_state", "load_snapshot", "reset"]

# The stat columns, in the device matrix's column order.
NUMERICS_STATS = ("l2", "maxabs", "nonfinite", "underflow", "ratio")

# Divergence detectors the tap evaluates; each maps 1:1 onto a
# ``numerics_<name>`` alert rule in observability/alerts.py.
NUMERICS_CONDITIONS = ("nonfinite", "grad_explosion", "dead_layer")

POLICIES = ("halt", "skip", "record")

_LOCK = threading.Lock()

# Module-level view the alert rules probe (sys-modules-free: alerts
# lives in the same package). Conditions reflect the most recent tap's
# detector state; history is the sampled time series.
_CONDITIONS: dict = {}
_HISTORY: deque = deque(maxlen=512)
_SNAPSHOTS: list = []
_LAST_SAMPLE = None

_GAUGE = _metrics.gauge(
    "mxnet_tpu_numerics_stat",
    "latest in-graph numerics statistic, by tapped tensor and stat",
    labels=("tensor", "stat"))
_GAUGE_GRAD_NORM = _metrics.gauge(
    "mxnet_tpu_numerics_grad_norm",
    "global gradient L2 norm from the captured step's in-graph tap")


class NumericsDivergenceError(ArithmeticError):
    """Training numerics diverged (non-finite gradients) under the
    ``halt`` policy of the in-graph numerics tap."""


def _env_policy():
    p = os.environ.get("MXNET_TPU_TORCH_NONFINITE_POLICY", "halt").strip() \
        or "halt"
    if p not in POLICIES:
        raise ValueError(
            f"MXNET_TPU_TORCH_NONFINITE_POLICY must be one of {POLICIES}, "
            f"got {p!r}")
    return p


def default_tap():
    """The tap a captured step arms when ``MXNET_TPU_TORCH_NUMERICS`` is
    truthy; None otherwise (the step's program is then unchanged)."""
    if os.environ.get("MXNET_TPU_TORCH_NUMERICS", "").strip().lower() in (
            "", "0", "false", "off", "no"):
        return None
    return NumericsTap()


def condition(name):
    """The detector state the ``numerics_<name>`` alert rule probes:
    ``{"active", "since_step", "evidence", "snapshot"}`` — or None when
    no tap has ever judged this condition (rule stays inert)."""
    with _LOCK:
        c = _CONDITIONS.get(name)
        return dict(c) if c is not None else None


def conditions():
    with _LOCK:
        return {k: dict(v) for k, v in _CONDITIONS.items()}


def history():
    """Sampled numerics observations, oldest first: ``{"t", "step",
    "grad_norm", "grads": {tensor: l2}, "nonfinite_rows": [...]}``."""
    with _LOCK:
        return [dict(h) for h in _HISTORY]


def last_snapshot():
    with _LOCK:
        return _SNAPSHOTS[-1] if _SNAPSHOTS else None


def snapshots():
    with _LOCK:
        return list(_SNAPSHOTS)


def snapshot_state():
    """The ``observability.dump()["numerics"]`` section."""
    with _LOCK:
        last = dict(_LAST_SAMPLE) if _LAST_SAMPLE else None
    return {"stats": list(NUMERICS_STATS),
            "conditions": conditions(),
            "last_sample": last,
            "history_len": len(_HISTORY),
            "snapshots": snapshots()}


def reset():
    """Clear conditions, history and snapshot bookkeeping (tests and
    drills call this between cases; on-disk snapshots are not
    deleted)."""
    global _LAST_SAMPLE
    with _LOCK:
        _CONDITIONS.clear()
        _HISTORY.clear()
        del _SNAPSHOTS[:]
        _LAST_SAMPLE = None


def _set_condition(name, active, evidence=None, step=None, snapshot=None):
    """Transition one detector; records a flight event on every flip so
    the incident's evidence window shows exactly when numerics went bad
    (and came back)."""
    with _LOCK:
        cur = _CONDITIONS.get(name)
        was = bool(cur and cur["active"])
        if cur is None:
            cur = _CONDITIONS[name] = {
                "active": False, "since_step": None, "evidence": None,
                "snapshot": None}
        cur["active"] = bool(active)
        if active:
            if not was:
                cur["since_step"] = step
            cur["evidence"] = evidence or {}
            if snapshot is not None:
                cur["snapshot"] = snapshot
    if bool(active) != was:
        _flight.record("numerics", op="condition", condition=name,
                       active=bool(active), step=step)
    return bool(active) != was


# ------------------------------------------------------------------ the tap

class NumericsTap:
    """Per-layer/per-param numerics telemetry compiled into a captured
    training step.

    Parameters
    ----------
    interval : int — sample every Nth step
        (``MXNET_TPU_TORCH_NUMERICS_INTERVAL``,
        default 10; ``0`` disables sampling — the side output stays in
        the program, zero-filled, so flipping sampling back on never
        retraces). Change at runtime with :meth:`set_interval`.
    stats : iterable of ``NUMERICS_STATS`` names — the selected columns
        (``MXNET_TPU_TORCH_NUMERICS_STATS`` comma list, default all).
        Unselected columns are zeroed by the in-program mask operand;
        change at runtime with :meth:`set_stats` — never a retrace.
    policy : ``halt`` | ``skip`` | ``record`` — what a non-finite
        gradient does (``MXNET_TPU_TORCH_NONFINITE_POLICY``, default
        ``halt``). ``halt``/``skip`` gate the weight write in-program
        (so the bad batch never lands) and then raise / skip on the
        host; ``record`` is observation-only and keeps the program
        bitwise-transparent even on bad batches. Baked into the program
        (changing it recaptures).
    snapshot_dir : where divergence snapshots publish
        (``MXNET_TPU_TORCH_NUMERICS_SNAPSHOT_DIR``; default
        ``<tempdir>/mxnet_tpu_numerics``).
    """

    def __init__(self, interval=None, stats=None, policy=None,
                 snapshot_dir=None, history_n=128, mad_k=None,
                 explosion_min_n=8, dead_eps=1e-12, dead_n=8):
        if interval is None:
            try:
                interval = int(os.environ.get(
                    "MXNET_TPU_TORCH_NUMERICS_INTERVAL", "10"))
            except ValueError:
                interval = 10
        if stats is None:
            raw = os.environ.get("MXNET_TPU_TORCH_NUMERICS_STATS", "").strip()
            stats = tuple(s.strip() for s in raw.split(",") if s.strip()) \
                if raw else NUMERICS_STATS
        unknown = sorted(set(stats) - set(NUMERICS_STATS))
        if unknown:
            raise ValueError(
                f"unknown numerics stats {unknown}; pick from "
                f"{NUMERICS_STATS}")
        self.policy = _env_policy() if policy is None else policy
        if self.policy not in POLICIES:
            raise ValueError(
                f"policy must be one of {POLICIES}, got {self.policy!r}")
        self.snapshot_dir = snapshot_dir
        self._interval = max(0, int(interval))
        self._selected = tuple(s for s in NUMERICS_STATS if s in set(stats))
        self._step = 0
        self._force_next = False
        self._sel_cache = None
        self._listeners = []
        # capture-build state
        self.rows = ()          # ((name, size), ...) fixed at build
        self._net = None
        self._trainer = None
        self._last_batch = None
        # detector state
        self._mad_k = float(os.environ.get("MXNET_TPU_TORCH_NUMERICS_MAD_K",
                                           "8") if mad_k is None else mad_k)
        self._explosion_min_n = int(explosion_min_n)
        self._norm_hist = deque(maxlen=int(history_n))
        self._dead_eps = float(dead_eps)
        self._dead_n = int(dead_n)
        self._dead_counts = {}
        self._clean_steps = 0
        self._nonfinite_steps = 0

    # ------------------------------------------------------ runtime knobs
    @property
    def interval(self):
        return self._interval

    def set_interval(self, n):
        """Change the sampling cadence at runtime — a pure operand
        change, never a retrace (tested by the compile-count probe)."""
        self._interval = max(0, int(n))
        return self

    @property
    def selected(self):
        return self._selected

    def set_stats(self, stats):
        """Change the selected stat columns at runtime — the in-program
        column mask is an operand, never a retrace."""
        unknown = sorted(set(stats) - set(NUMERICS_STATS))
        if unknown:
            raise ValueError(
                f"unknown numerics stats {unknown}; pick from "
                f"{NUMERICS_STATS}")
        self._selected = tuple(s for s in NUMERICS_STATS
                               if s in set(stats))
        self._sel_cache = None
        return self

    def request_sample(self):
        """Force the NEXT step to sample regardless of cadence (the
        compiled-tap ``Monitor`` calls this from ``tic()``)."""
        self._force_next = True
        return self

    def add_listener(self, fn):
        """``fn(step, stats_by_tensor)`` called on every sampled step
        (``stats_by_tensor``: ``{name: {"size": n, <stat>: value}}``)."""
        self._listeners.append(fn)
        return fn

    def sel_values(self):
        """The column-mask operand for the selected stats (cached: the
        steady-state step builds no per-step numpy garbage)."""
        cached = self._sel_cache
        if cached is None:
            import numpy as np

            cached = self._sel_cache = np.asarray(
                [1.0 if s in self._selected else 0.0
                 for s in NUMERICS_STATS], np.float32)
        return cached

    def tick(self):
        """Advance the tap's step counter; True when this step samples
        (cadence hit or a forced sample)."""
        step = self._step
        self._step += 1
        sampled = self._force_next or (
            self._interval > 0 and step % self._interval == 0)
        self._force_next = False
        return sampled

    @property
    def gates_updates(self):
        """False: the port's step does not gate its weight write on the
        finite flag in the graph (ROADMAP Queue 3)."""
        return False

    # -------------------------------------------------------- capture-side
    def bind(self, net, trainer):
        self._net = net
        self._trainer = trainer
        return self

    def plan_signature(self):
        """The tap's contribution to the capture fingerprint: row plan +
        column schema + gating semantics (a changed plan or policy is a
        different program; interval/selection are operands and do NOT
        appear here)."""
        return {"rows": tuple(n for n, _ in self.rows),
                "stats": NUMERICS_STATS,
                "gates": self.gates_updates}

    def graph_stats(self, grads, params_pre, params_post, acts, sel_t):
        """The ``(rows, len(NUMERICS_STATS))`` float32 stats matrix on the
        device, from the step's tensors (``[(name, tensor)]`` lists), times
        the column mask ``sel_t`` (a device tensor: a changed selection
        changes a slot, never the graph). Records ``self.rows`` (name,
        size), the row plan the emission decodes by."""
        import torch

        named = [(f"grad:{name}", None, g) for name, g in grads]
        named += [(f"param:{name}", None, p) for name, p in params_pre]
        named += [(f"update:{name}", pre, post) for (name, pre), (_, post)
                  in zip(params_pre, params_post)]
        named += [(f"act:{name}", None, a) for name, a in acts]
        self.rows = tuple((name, int(x.numel())) for name, _, x in named)
        dev = sel_t.device
        if not named:
            return torch.zeros((0, len(NUMERICS_STATS)), dtype=torch.float32,
                               device=dev)
        rows = []
        for _name, pre, x in named:
            v = x.detach().float().reshape(-1)
            if pre is not None:
                d = pre.detach().float().reshape(-1)
                v = v - d
            rows.append(_row(v, None if pre is None else d))
        return torch.stack(rows) * sel_t.to(torch.float32)[None, :]

    # --------------------------------------------------------- host-side
    def on_step(self, step, finite_ok, stats_np, batch=None):
        """Per-step host hook from the captured call: ``finite_ok`` is
        the program's fused all-finite flag (every step), ``stats_np``
        the pulled stats matrix on sampled steps (None otherwise).
        Updates metrics/flight/history, evaluates the divergence
        conditions, and applies the non-finite policy."""
        if batch is not None:
            self._last_batch = batch
        sample = None
        if stats_np is not None:
            with _trace.span("numerics.sample", step=step):
                sample = self._emit(step, stats_np)
        if finite_ok is None and sample is not None \
                and "nonfinite" in self._selected:
            # record-policy programs carry no per-step finite flag: the
            # sampled matrix's nonfinite column is the finite signal
            finite_ok = not sample["nonfinite_rows"]
        if finite_ok is not None:
            self._judge_nonfinite(step, finite_ok, sample)
        if sample is not None and (finite_ok is None or finite_ok):
            self._judge_explosion(step, sample)
            self._judge_dead_layers(step, sample)

    # emission ----------------------------------------------------------
    def _emit(self, step, stats_np):
        global _LAST_SAMPLE
        import numpy as np

        _STATS["numerics_samples"] += 1
        mat = np.asarray(stats_np, np.float64)
        by_tensor = {}
        grads = {}
        under = {}
        nonfinite_rows = []
        grad_sq = 0.0
        sel = set(self._selected)
        for i, (name, size) in enumerate(self.rows):
            if i >= mat.shape[0]:
                break
            rec = {"size": size}
            for j, stat in enumerate(NUMERICS_STATS):
                if stat not in sel:
                    continue
                val = float(mat[i, j])
                rec[stat] = val
                self._gauge_set(name, stat, val)
            by_tensor[name] = rec
            l2 = rec.get("l2")
            if name.startswith("grad:"):
                if l2 is not None:
                    grads[name[5:]] = l2
                    if np.isfinite(l2):
                        grad_sq += l2 * l2
                if "underflow" in rec:
                    under[name[5:]] = rec["underflow"]
            nf = rec.get("nonfinite")
            if nf:
                nonfinite_rows.append(name)
        grad_norm = float(np.sqrt(grad_sq)) if "l2" in sel else None
        if grad_norm is not None:
            _GAUGE_GRAD_NORM.set(grad_norm)
        sample = {"t": time.time(), "step": step, "grad_norm": grad_norm,
                  "grads": grads, "underflow": under,
                  "nonfinite_rows": nonfinite_rows,
                  # full per-tensor stats: what a numerics snapshot
                  # records as the CAPTURED run's reference values for
                  # an eager replay's comparison
                  "tensors": by_tensor}
        with _LOCK:
            _HISTORY.append(sample)
            _LAST_SAMPLE = sample
        _flight.record("numerics", op="sample", step=step,
                       grad_norm=grad_norm,
                       nonfinite_rows=len(nonfinite_rows))
        for fn in self._listeners:
            try:
                fn(step, by_tensor)
            except Exception:
                pass  # a broken listener must never fail the step
        return sample

    def _gauge_set(self, tensor, stat, value):
        _GAUGE.set(value, tensor=tensor, stat=stat)

    # detectors ---------------------------------------------------------
    def _judge_nonfinite(self, step, finite_ok, sample):
        if finite_ok:
            self._clean_steps += 1
            # a few consecutive clean steps = the divergence is over
            if self._nonfinite_steps and self._clean_steps >= 4:
                self._nonfinite_steps = 0
                _set_condition("nonfinite", False, step=step)
            return
        self._clean_steps = 0
        self._nonfinite_steps += 1
        _STATS["numerics_nonfinite_steps"] += 1
        evidence = {"nonfinite_steps": self._nonfinite_steps,
                    "policy": self.policy}
        if sample is not None and sample["nonfinite_rows"]:
            evidence["nonfinite_rows"] = sample["nonfinite_rows"]
            evidence["first_nonfinite"] = sample["nonfinite_rows"][0]
            # forward-order activation onset names the offending LAYER
            # (a NaN source poisons every gradient via backward, but
            # only the layers downstream of it in the forward)
            for name in sample["nonfinite_rows"]:
                if name.startswith("act:"):
                    evidence["first_nonfinite_act"] = name
                    break
        flipped = _set_condition("nonfinite", True, evidence=evidence,
                                 step=step)
        if flipped:
            path = self.write_snapshot("nonfinite", step=step,
                                       stats=sample)
            if path is not None:
                _set_condition("nonfinite", True, evidence=evidence,
                               step=step, snapshot=path)
        if self.policy == "halt":
            _STATS["numerics_halts"] += 1
            raise NumericsDivergenceError(
                f"non-finite gradient at captured step {step} "
                f"(policy=halt; snapshot: {last_snapshot()})")

    def _judge_explosion(self, step, sample):
        norm = sample.get("grad_norm")
        if norm is None or not _finite(norm):
            return
        hist = self._norm_hist
        if len(hist) >= self._explosion_min_n:
            med = _median(hist)
            mad = _median([abs(v - med) for v in hist])
            sigma = 1.4826 * mad
            # spread floor (5% of median) + a hard 4x floor: only a
            # multiple-of-itself explosion can page, never CI jitter
            limit = max(med + self._mad_k * max(sigma, 0.05 * med),
                        4.0 * med)
            if med > 0 and norm > limit:
                evidence = {"grad_norm": norm, "limit": limit,
                            "median": med, "mad": mad, "k": self._mad_k,
                            "n": len(hist), "step": step}
                flipped = _set_condition("grad_explosion", True,
                                         evidence=evidence, step=step)
                if flipped:
                    path = self.write_snapshot("grad_explosion",
                                               step=step, stats=sample)
                    if path is not None:
                        _set_condition("grad_explosion", True,
                                       evidence=evidence, step=step,
                                       snapshot=path)
                return  # outliers stay out of their own baseline
        hist.append(norm)
        _set_condition("grad_explosion", False, step=step)

    def _judge_dead_layers(self, step, sample):
        grads = sample.get("grads") or {}
        under = sample.get("underflow") or {}
        norm = sample.get("grad_norm")
        if not grads:
            return
        dead = []
        for name, l2 in grads.items():
            is_dead = l2 <= self._dead_eps \
                or under.get(name, 0.0) >= 0.99
            n = self._dead_counts.get(name, 0) + 1 if is_dead else 0
            self._dead_counts[name] = n
            if n >= self._dead_n:
                dead.append(name)
        # a globally-dead net (norm ~0) is "training finished/broken",
        # not one dead layer among live ones
        if dead and norm is not None and norm > self._dead_eps \
                and len(dead) < len(grads):
            evidence = {"dead_layers": sorted(dead),
                        "samples": self._dead_n, "step": step}
            flipped = _set_condition("dead_layer", True,
                                     evidence=evidence, step=step)
            if flipped:
                path = self.write_snapshot("dead_layer", step=step,
                                           stats=sample)
                if path is not None:
                    _set_condition("dead_layer", True, evidence=evidence,
                                   step=step, snapshot=path)
        else:
            _set_condition("dead_layer", False, step=step)

    # snapshots ---------------------------------------------------------
    def _snapshot_root(self):
        d = self.snapshot_dir \
            or os.environ.get("MXNET_TPU_TORCH_NUMERICS_SNAPSHOT_DIR",
                              "").strip()
        if not d:
            import tempfile

            d = os.path.join(tempfile.gettempdir(), "mxnet_tpu_numerics")
        return d

    def write_snapshot(self, reason, step=None, stats=None):
        """Publish one numerics snapshot — the forensic bundle
        an eager replay starts from: the batch, every
        parameter, the optimizer state (``Trainer.get_states_bytes``)
        and the tap's row stats — through the checkpoint machinery's
        atomic-write discipline (fsynced files in a temp dir, one final
        rename). Returns the published path, or None when the tap has
        no bound net/trainer. Never raises: a full disk must not take
        the training step down with it."""
        if self._net is None or self._trainer is None:
            return None
        try:
            return self._write_snapshot_impl(reason, step, stats)
        except Exception:
            return None

    def _state_params(self):
        """[(name, tensor)]: the bound trainer's parameters (a
        ShardedTrainer's masters, else the net's)."""
        params = getattr(self._trainer, "params", None)
        if isinstance(params, dict):
            return sorted(params.items())
        return sorted((n, p.data()) for n, p in
                      self._net._param_objects().items())

    def _write_snapshot_impl(self, reason, step, stats):
        import io as _io

        import numpy as np

        from ..resilience.checkpoint import atomic_write_bytes

        root = self._snapshot_root()
        os.makedirs(root, exist_ok=True)
        tag = f"numerics-{step if step is not None else self._step:08d}" \
              f"-{int(time.time() * 1000) % 100000:05d}"
        final = os.path.join(root, tag)
        tmp = os.path.join(root, f".tmp-{tag}-{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)

        params = {name: _host(t) for name, t in self._state_params()}
        buf = _io.BytesIO()
        np.savez(buf, **params)
        atomic_write_bytes(os.path.join(tmp, "params.npz"),
                           buf.getvalue())
        batch_files = None
        if self._last_batch is not None:
            x_b, y_b = self._last_batch
            buf = _io.BytesIO()
            np.savez(buf, x=_host(x_b), y=_host(y_b))
            atomic_write_bytes(os.path.join(tmp, "batch.npz"),
                               buf.getvalue())
            batch_files = "batch.npz"
        atomic_write_bytes(os.path.join(tmp, "trainer.state"),
                           self._trainer.get_states_bytes())
        manifest = {
            "schema": 1,
            "reason": reason,
            "step": step,
            "t": time.time(),
            "policy": self.policy,
            "stats_schema": list(NUMERICS_STATS),
            "selected": list(self._selected),
            "rows": [[n, s] for n, s in self.rows],
            "sample": stats,
            "params": "params.npz",
            "batch": batch_files,
            "trainer_state": "trainer.state",
            "param_names": sorted(params),
        }
        atomic_write_bytes(
            os.path.join(tmp, "manifest.json"),
            json.dumps(manifest, sort_keys=True, default=str).encode())
        os.replace(tmp, final)
        _STATS["numerics_snapshots"] += 1
        _flight.record("numerics", op="snapshot", reason=reason,
                       step=step, path=final)
        with _LOCK:
            _SNAPSHOTS.append(final)
            del _SNAPSHOTS[:-16]
        self._prune(root)
        return final

    @staticmethod
    def _prune(root):
        try:
            keep = int(os.environ.get(
                "MXNET_TPU_TORCH_NUMERICS_SNAPSHOT_KEEP", "4"))
        except ValueError:
            keep = 4
        if keep <= 0:
            return
        try:
            entries = []
            for name in os.listdir(root):
                if not name.startswith("numerics-"):
                    continue
                path = os.path.join(root, name)
                try:
                    entries.append((os.path.getmtime(path), path))
                except OSError:
                    continue
        except OSError:
            return
        import shutil

        # mtime order, NOT name order: the tag leads with the step
        # number, so after a restart a new run's step-5 snapshot would
        # sort before an old run's step-400 ones and be pruned first —
        # deleting exactly the forensic bundle the fresh incident's
        # evidence points at
        entries.sort()
        for _, path in entries[:-keep]:
            shutil.rmtree(path, ignore_errors=True)


def load_snapshot(path):
    """Read one published numerics snapshot back:
    ``{"manifest", "params": {name: np}, "batch": (x, y) | None,
    "trainer_state": bytes}`` (the bisect tool's input)."""
    import numpy as np

    with open(os.path.join(path, "manifest.json"), encoding="utf-8") as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, manifest["params"])) as z:
        params = {k: z[k].copy() for k in z.files}
    batch = None
    if manifest.get("batch"):
        with np.load(os.path.join(path, manifest["batch"])) as z:
            batch = (z["x"].copy(), z["y"].copy())
    state = None
    st = manifest.get("trainer_state")
    if st and os.path.isfile(os.path.join(path, st)):
        with open(os.path.join(path, st), "rb") as f:
            state = f.read()
    return {"manifest": manifest, "params": params, "batch": batch,
            "trainer_state": state}


def _host(t):
    """A tensor (bf16 as float32) or array as a numpy array."""
    if hasattr(t, "detach"):
        import torch

        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def _row(v, den):
    """One stats row of a flat float32 tensor ``v``: l2, max |v|, the
    NaN/Inf count, the fp16-underflow fraction of its nonzeros, and the
    norm ratio to ``den`` (update rows), as ``mxnet_tpu`` computes them."""
    import torch

    zero = torch.zeros((), dtype=torch.float32, device=v.device)
    l2 = torch.sqrt(torch.sum(v * v))
    maxabs = torch.max(torch.abs(v)) if v.numel() else zero
    nonfinite = torch.sum((~torch.isfinite(v)).to(torch.float32))
    nz = v != 0.0
    nonzero = torch.sum(nz.to(torch.float32))
    under = torch.sum((nz & (v.to(torch.float16) == 0.0)).to(
        torch.float32)) / torch.clamp(nonzero, min=1.0)
    if den is None:
        ratio = zero
    else:
        ratio = l2 / (torch.sqrt(torch.sum(den * den)) + 1e-12)
    return torch.stack([l2, maxabs, nonfinite, under, ratio])


def _median(values):
    vals = sorted(values)
    n = len(vals)
    mid = n // 2
    return vals[mid] if n % 2 else (vals[mid - 1] + vals[mid]) / 2.0


def _finite(v):
    return v == v and v not in (float("inf"), float("-inf"))

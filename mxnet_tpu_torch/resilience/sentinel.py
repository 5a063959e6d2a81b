"""Numeric-health sentinel (port of ``mxnet_tpu/resilience/sentinel.py``).

- :meth:`HealthSentinel.attach` hooks it into a gluon ``Trainer``:
  ``before_update`` runs after the gradient all-reduce and before the
  update sweep, one fused finiteness reduction over every gradient (and,
  with ``grad_norm_threshold``, the global gradient norm) and one host
  read, so an unhealthy batch never touches the weights.
- :meth:`HealthSentinel.check_finite` is what ``serving.BatchServer`` and
  the fleet's process replicas run on every batch's outputs.

Policies (``MXNET_TPU_TORCH_HEALTH_POLICY`` or the constructor): ``raise``
raises :class:`NumericHealthError`; ``skip_batch`` drops the step (the
``health_skipped_steps`` counter, shared with AMP overflow skips);
``rollback`` restores the last valid checkpoint (parameters, optimizer
state, RNG, loss scaler) through the attached ``CheckpointManager`` and
skips the step. On the inference path ``rollback`` degrades to
``skip_batch``.
"""
from __future__ import annotations

import os

__all__ = ["HealthSentinel", "NumericHealthError", "note_skip",
           "note_check", "note_rollback", "stats", "reset_stats",
           "all_finite"]

POLICIES = ("raise", "skip_batch", "rollback")

_STATS = {"sentinel_checks": 0, "sentinel_nonfinite": 0,
          "sentinel_grad_norm_trips": 0, "sentinel_rollbacks": 0,
          "health_skipped_steps": 0, "amp_overflow_skips": 0}


class NumericHealthError(ArithmeticError):
    """Numerics went bad (NaN/Inf, or a grad-norm explosion) under the
    ``raise`` policy."""


def note_skip(reason="sentinel"):
    """One skipped update step: sentinel skips and AMP overflow skips
    share ``health_skipped_steps``."""
    _STATS["health_skipped_steps"] += 1
    if reason == "amp_overflow":
        _STATS["amp_overflow_skips"] += 1


def note_check(healthy, kind="nonfinite"):
    """One health check run outside ``before_update`` (a captured step's
    in-graph flag), counted in the same series."""
    _STATS["sentinel_checks"] += 1
    if not healthy:
        _STATS["sentinel_grad_norm_trips" if kind == "grad_norm"
               else "sentinel_nonfinite"] += 1


def note_rollback():
    _STATS["sentinel_rollbacks"] += 1


def stats():
    return dict(_STATS)


def reset_stats():
    for k in _STATS:
        _STATS[k] = 0


def all_finite(arrays):
    """True when every floating-point entry of ``arrays`` (tensors or
    numpy arrays) is finite. The tensors are checked on their device by
    one reduction over all of them (a single output is reduced in place;
    several are flattened into one buffer first), then one host read."""
    import numpy as np
    import torch

    tensors, hosts = [], []
    for a in arrays:
        if isinstance(a, torch.Tensor):
            if a.is_floating_point() and a.numel():
                tensors.append(a)
        else:
            h = np.asarray(a)
            if np.issubdtype(h.dtype, np.floating):
                hosts.append(h)
    ok = all(bool(np.isfinite(h).all()) for h in hosts)
    if not ok or not tensors:
        return ok
    if len(tensors) == 1:
        flat = tensors[0]
    else:
        dev = tensors[0].device
        flat = torch.cat([t.detach().reshape(-1).to(dev, torch.float32)
                          for t in tensors])
    return bool(torch.isfinite(flat).all().item())


class HealthSentinel:
    """Per-step numeric watchdog for a gluon Trainer, and the output check
    of the serving path.

    Parameters
    ----------
    policy : 'raise' | 'skip_batch' | 'rollback' (default env
        ``MXNET_TPU_TORCH_HEALTH_POLICY``, else 'raise')
    grad_norm_threshold : also trip when the global gradient L2 norm
        exceeds it (None: finiteness only)
    check_every : check every Nth step
    checkpoint_manager : required for 'rollback'

    Usage::

        sentinel = HealthSentinel(policy="skip_batch").attach(trainer)
        trainer.step(batch)          # checked before the update
    """

    def __init__(self, policy=None, grad_norm_threshold=None, check_every=1,
                 checkpoint_manager=None):
        if policy is None:
            policy = os.environ.get("MXNET_TPU_TORCH_HEALTH_POLICY", "raise")
        if policy not in POLICIES:
            raise ValueError(
                f"policy must be one of {POLICIES}, got {policy!r} "
                "(check MXNET_TPU_TORCH_HEALTH_POLICY)")
        self.policy = policy
        self.grad_norm_threshold = (None if grad_norm_threshold is None
                                    else float(grad_norm_threshold))
        self.check_every = max(1, int(check_every))
        self.manager = checkpoint_manager
        self._trainer = None
        self._net = None
        self._step = 0
        self.last_reason = None

    def attach(self, trainer, net=None, checkpoint_manager=None):
        """Register with a gluon Trainer (its step consults the sentinel
        before the update). Returns self."""
        if checkpoint_manager is not None:
            self.manager = checkpoint_manager
        if self.policy == "rollback":
            if self.manager is None:
                raise ValueError(
                    "rollback policy needs a CheckpointManager "
                    "(pass checkpoint_manager= to attach())")
            if net is None:
                raise ValueError(
                    "rollback policy needs the net (pass net= to "
                    "attach()): restoring optimizer state without the "
                    "parameters would leave an inconsistent model")
        self._trainer = trainer
        self._net = net
        trainer._sentinel = self
        return self

    def detach(self):
        if self._trainer is not None \
                and getattr(self._trainer, "_sentinel", None) is self:
            self._trainer._sentinel = None
        self._trainer = None
        return self

    # ------------------------------------------------------------- checks
    @staticmethod
    def _grads(trainer):
        return [p.grad() for p in trainer._params if p.grad_req != "null"]

    def _grads_healthy(self, trainer):
        from ..ops import optimizer_ops

        grads = self._grads(trainer)
        if not grads:
            return True, None
        if not bool(optimizer_ops.multi_all_finite(*grads).item()):
            _STATS["sentinel_nonfinite"] += 1
            return False, "non-finite gradient (NaN/Inf)"
        if self.grad_norm_threshold is not None:
            sq = optimizer_ops.multi_sum_sq(*grads, num_arrays=len(grads))
            norm = float(sum(s.item() for s in sq)) ** 0.5
            if norm > self.grad_norm_threshold:
                _STATS["sentinel_grad_norm_trips"] += 1
                return False, (f"global grad norm {norm:.3e} exceeds "
                               f"threshold {self.grad_norm_threshold:.3e}")
        return True, None

    def before_update(self, trainer):
        """Called by ``Trainer.step``/``update`` before the update sweep;
        True when the update should proceed."""
        self._step += 1
        if (self._step - 1) % self.check_every:
            return True
        _STATS["sentinel_checks"] += 1
        healthy, reason = self._grads_healthy(trainer)
        if healthy:
            return True
        return self._apply_policy(trainer, reason)

    def check_finite(self, arrays, what="serving batch"):
        """Finiteness check over a list of outputs (tensors or arrays):
        True when healthy; otherwise ``raise`` raises and the other
        policies return False (no ``note_skip``: poisoned inference
        batches have their own serving counter)."""
        if not arrays:
            return True
        _STATS["sentinel_checks"] += 1
        if all_finite(arrays):
            return True
        _STATS["sentinel_nonfinite"] += 1
        self.last_reason = f"non-finite values in {what}"
        if self.policy == "raise":
            raise NumericHealthError(self.last_reason)
        return False

    def check_loss(self, loss):
        """Explicit loss check after the forward; applies the policy to a
        non-finite loss."""
        _STATS["sentinel_checks"] += 1
        if all_finite([loss]):
            return True
        _STATS["sentinel_nonfinite"] += 1
        return self._apply_policy(self._trainer, "non-finite loss")

    def _apply_policy(self, trainer, reason):
        self.last_reason = reason
        if self.policy == "raise":
            raise NumericHealthError(
                f"numeric health check failed at sentinel step "
                f"{self._step}: {reason}")
        if self.policy == "skip_batch":
            note_skip("sentinel")
            return False
        if self.manager is None:
            raise NumericHealthError(
                f"rollback requested ({reason}) but no CheckpointManager "
                "is attached")
        restored = self.manager.restore_latest(net=self._net,
                                               trainer=trainer)
        if restored is None:
            raise NumericHealthError(
                f"rollback requested ({reason}) but no valid checkpoint "
                f"exists under {self.manager.directory}")
        note_skip("sentinel")
        _STATS["sentinel_rollbacks"] += 1
        return False

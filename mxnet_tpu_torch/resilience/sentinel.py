"""Numeric-health sentinel (port of ``mxnet_tpu/resilience/sentinel.py``,
its serving half).

:meth:`HealthSentinel.check_finite` is what ``serving.BatchServer`` and the
fleet's process replicas run on every batch's outputs: one finiteness
reduction on the device over all floating-point outputs and one host read
of its flag, so a poisoned batch fails only its own requests. Policies
(``MXNET_TPU_TORCH_HEALTH_POLICY`` or the constructor): ``raise`` raises
:class:`NumericHealthError`; ``skip_batch`` (and ``rollback``, which has no
trainer state to restore on the inference path) returns False.

Not ported: attaching the sentinel to a Trainer (gradient checks before
the update, rollback through a checkpoint manager) waits for the training
half of ROADMAP Queue 1 item 12; :meth:`HealthSentinel.attach` raises.
"""
from __future__ import annotations

import os

from ..base import MXNetError

__all__ = ["HealthSentinel", "NumericHealthError", "stats", "reset_stats",
           "all_finite"]

POLICIES = ("raise", "skip_batch", "rollback")

_STATS = {"sentinel_checks": 0, "sentinel_nonfinite": 0}


class NumericHealthError(ArithmeticError):
    """Numerics went bad (NaN/Inf) under the ``raise`` policy."""


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
    """Output watchdog of the serving path.

    Parameters
    ----------
    policy : 'raise' | 'skip_batch' | 'rollback' (default env
        ``MXNET_TPU_TORCH_HEALTH_POLICY``, else 'raise')
    """

    def __init__(self, policy=None):
        if policy is None:
            policy = os.environ.get("MXNET_TPU_TORCH_HEALTH_POLICY", "raise")
        if policy not in POLICIES:
            raise ValueError(
                f"policy must be one of {POLICIES}, got {policy!r} "
                "(check MXNET_TPU_TORCH_HEALTH_POLICY)")
        self.policy = policy
        self.last_reason = None

    def attach(self, trainer, net=None, checkpoint_manager=None):
        raise MXNetError(
            "HealthSentinel.attach: the Trainer's health hook is not "
            "ported yet (ROADMAP Queue 1 item 12, training half); the "
            "port's sentinel checks serving outputs (check_finite)")

    def check_finite(self, arrays, what="serving batch"):
        """Finiteness check over a list of outputs (tensors or arrays).
        Returns True when healthy; otherwise applies the policy: ``raise``
        raises :class:`NumericHealthError`, the others return False
        (``rollback`` degrades to ``skip_batch``: there is no trainer
        state to restore on the inference path)."""
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

"""mxnet_tpu_torch.resilience — the serving runtime's failure paths (port
of ``mxnet_tpu/resilience``, its serving half).

- :mod:`faults` — the deterministic fault-injection harness
  (``MXNET_TPU_TORCH_FAULTS``) and every serving kind's hook;
- :class:`HealthSentinel` — the NaN/Inf check over a batch's outputs
  (``raise | skip_batch`` policies);
- :mod:`watchdog` — phase deadlines (``batch``, ``probe``), crash reports
  (:class:`StallError`) and the peer bookkeeping the fleet supervisor
  uses.

Not ported (ROADMAP Queue 1 item 12, training half): checkpoints,
elastic retry, the integrity layer, and the trainers' hooks.
"""
from . import faults
from . import sentinel as _sentinel_mod
from . import watchdog
from .sentinel import HealthSentinel, NumericHealthError
from .watchdog import StallError

__all__ = ["HealthSentinel", "NumericHealthError", "StallError", "faults",
           "watchdog", "stats", "reset_stats"]


def stats():
    """All resilience counters as one flat dict."""
    out = {}
    out.update(_sentinel_mod.stats())
    out.update(faults.stats())
    out.update(watchdog.stats())
    return out


def reset_stats():
    _sentinel_mod.reset_stats()
    faults.reset_stats()
    watchdog.reset_stats()

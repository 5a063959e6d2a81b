"""mxnet_tpu_torch.resilience — survivable training and serving (port of
``mxnet_tpu/resilience``).

- :class:`CheckpointManager` — atomic, versioned, CRC-verified,
  reshardable (format v2) checkpoints with async publish, retention and
  verified fall-back restore;
- :class:`HealthSentinel` — NaN/Inf and grad-norm check of a gluon
  Trainer's gradients (``raise | skip_batch | rollback``) and of serving
  outputs;
- :mod:`watchdog` — phase deadlines (``step``, ``batch``, ``probe``,
  ``collective``), crash reports (:class:`StallError`), peer bookkeeping
  and the liveness of a job of several processes (beats, pods of host
  failure domains, the survivors' barrier, :class:`PeerLostError`);
- :mod:`elastic` — an out-of-memory step runs again as accumulated
  microbatches; a lost peer shrinks the mesh;
- :mod:`faults` — the deterministic fault-injection harness;
- :mod:`integrity` — step fingerprints (a CUDA fold kernel, also split
  over several ranks), the shadow replay audit, the device self-test and
  quarantine, checkpoint-manifest fingerprints, serving golden-query
  audits and SIGTERM preemption.

The checkpoint manager's pod commit writes each host's own shards.
"""
from . import faults
from . import checkpoint as _checkpoint_mod
from . import sentinel as _sentinel_mod
from . import watchdog
from . import elastic
from . import integrity
from .checkpoint import (CheckpointManager, CheckpointCorruptError,
                         atomic_write_bytes)
from .sentinel import HealthSentinel, NumericHealthError, note_skip
from .watchdog import StallError, PeerLostError

__all__ = ["CheckpointManager", "CheckpointCorruptError",
           "atomic_write_bytes", "HealthSentinel", "NumericHealthError",
           "note_skip", "StallError", "PeerLostError", "faults",
           "watchdog", "elastic", "integrity", "stats", "reset_stats"]


def stats():
    """All resilience counters as one flat dict."""
    out = {}
    out.update(_sentinel_mod.stats())
    out.update(_checkpoint_mod.stats())
    out.update(faults.stats())
    out.update(watchdog.stats())
    out.update(elastic.stats())
    out.update(integrity.stats())
    return out


def reset_stats():
    _sentinel_mod.reset_stats()
    _checkpoint_mod.reset_stats()
    faults.reset_stats()
    watchdog.reset_stats()
    elastic.reset_stats()
    integrity.reset_stats()

"""Elastic step execution: survive a step OOM by microbatch accumulation,
and a lost peer by a mesh shrink (port of
``mxnet_tpu/resilience/elastic.py``).

``parallel.ShardedTrainer.step`` catches an out-of-memory step (a real
``torch.OutOfMemoryError``, in the step itself or in the capture of its
graph, or the ``oom_step`` fault) and runs the same batch again as N
accumulated microbatches, doubling N until the step fits or the floor is
reached. The shrink is sticky: later steps go straight to the accumulated
program. Gradients of the microbatches are taken at the same parameters,
summed, divided by N and applied in one update, so the retried step is
bitwise an explicit ``step(x, y, microbatches=N)``.

A lost peer (``watchdog.PeerLostError``) on a trainer with a checkpoint
manager shrinks the mesh to the survivors and reloads the latest
checkpoint onto it (``ShardedTrainer._recover_peer_loss``);
:func:`rearm_microbatches` keeps the per-rank microbatch where it last
fit.

Knobs: ``MXNET_TPU_TORCH_ELASTIC`` (``0`` lets the OOM surface),
``MXNET_TPU_TORCH_ELASTIC_MIN_MICROBATCH`` (the fewest rows a microbatch
may keep, default 1) and ``MXNET_TPU_TORCH_MESH_SHRINK`` (``0`` leaves a
lost peer terminal). Counters: ``elastic_oom_events``,
``elastic_shrinks``, ``elastic_accum_steps``, ``elastic_mesh_shrinks``.
"""
from __future__ import annotations

import os

from . import faults

__all__ = ["enabled", "min_microbatch", "is_oom_error", "next_microbatches",
           "mesh_shrink_enabled", "rearm_microbatches", "stats",
           "reset_stats"]

_STATS = {
    "elastic_oom_events": 0,   # OOMs caught from a step
    "elastic_shrinks": 0,      # microbatch doublings performed
    "elastic_accum_steps": 0,  # steps run as accumulated microbatches
    "elastic_mesh_shrinks": 0,  # peer losses survived on a smaller mesh
}


def stats():
    return dict(_STATS)


def reset_stats():
    for k in _STATS:
        _STATS[k] = 0


def enabled():
    return os.environ.get("MXNET_TPU_TORCH_ELASTIC", "1").strip().lower() \
        not in ("0", "false", "off")


def min_microbatch():
    try:
        return max(1, int(os.environ.get(
            "MXNET_TPU_TORCH_ELASTIC_MIN_MICROBATCH", "1")))
    except ValueError:
        return 1


def is_oom_error(err):
    """Is ``err`` a step OOM worth retrying at a smaller microbatch? A
    ``torch.OutOfMemoryError`` (also as the cause of a capture's
    ``CaptureError``), an allocator message saying so, or the injected
    ``oom_step`` fault."""
    seen = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        if isinstance(err, (faults.InjectedOOM, _torch_oom())):
            return True
        if "out of memory" in str(err).lower():
            return True
        err = err.__cause__ or err.__context__
    return False


def _torch_oom():
    import torch

    return getattr(torch, "OutOfMemoryError",
                   getattr(torch.cuda, "OutOfMemoryError", MemoryError))


def next_microbatches(n, rows, shards=1):
    """The accumulation count to try after an OOM at ``n`` microbatches of
    a ``rows``-row batch, or None when no smaller microbatch is possible:
    ``2n`` must divide ``rows``, keep at least the minimum rows and split
    over ``shards`` data-parallel ranks."""
    nxt = int(n) * 2
    rows = int(rows)
    if nxt > rows or rows % nxt:
        return None
    mb = rows // nxt
    if mb < min_microbatch():
        return None
    if shards > 1 and mb % shards:
        return None
    return nxt


def mesh_shrink_enabled():
    """Is peer-loss recovery by mesh shrink on?
    (``MXNET_TPU_TORCH_MESH_SHRINK``, default on; consulted only when the
    trainer has a CheckpointManager to reload the state from.)"""
    return os.environ.get("MXNET_TPU_TORCH_MESH_SHRINK", "1").strip() \
        .lower() not in ("0", "false", "off")


def rearm_microbatches(n, old_dp, new_dp):
    """The sticky accumulation count after a shrink from ``old_dp`` to
    ``new_dp`` batch shards: a run already at N microbatches had proven
    only rows / (N * old_dp) rows fit a rank, so N scales by the shard
    ratio; a run still whole (n == 1) stays whole."""
    n = max(1, int(n))
    if n == 1 or int(new_dp) >= int(old_dp):
        return n
    return n * max(1, int(old_dp) // int(new_dp))

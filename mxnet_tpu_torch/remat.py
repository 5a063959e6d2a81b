"""Activation rematerialization (port of ``mxnet_tpu/remat.py``).

``mxnet_tpu`` wraps the traced forward in ``jax.checkpoint`` with a policy
(the reference's gradient mirroring, ``MXNET_BACKWARD_DO_MIRROR``). The
port wraps it in ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``:
the forward keeps no activation but its inputs, and the backward runs the
forward again before differentiating it. So every kernel of the wrapped
forward launches twice a step (K1 once in the forward and once in the
recomputation, then K2).

:func:`resolve_policy` maps ``mxnet_tpu``'s specs:

- ``True`` / ``None``: recompute everything (no ``context_fn``);
- a name of ``jax.checkpoint_policies`` that has a counterpart in a
  selective-checkpoint policy: ``'nothing_saveable'`` (recompute
  everything), ``'everything_saveable'`` (save every op's output),
  ``'dots_saveable'`` and ``'dots_with_no_batch_dims_saveable'`` (save the
  matrix products, recompute the rest);
- a callable: a selective-checkpoint policy ``fn(ctx, op, *args,
  **kwargs)`` returning a ``torch.utils.checkpoint.CheckpointPolicy`` or a
  bool (True: save);
- any other name raises ``ValueError`` with ``mxnet_tpu``'s text.

Entry points: ``ShardedTrainer(remat=...)`` (the whole forward) and
``TransformerLM(remat=...)`` (each block, through ``gluon.contrib.nn.Remat``).
"""
from __future__ import annotations

import functools
import os

import torch

__all__ = ["resolve_policy", "mirror_enabled", "checkpointed"]


def mirror_enabled():
    """True when the reference's mirroring env flag is set."""
    v = os.environ.get("MXNET_BACKWARD_DO_MIRROR")
    return v not in (None, "", "0", "false", "False")


def _matmul_ops():
    aten = torch.ops.aten
    return {aten.mm.default, aten.bmm.default, aten.addmm.default,
            aten.baddbmm.default, aten.matmul.default}


def _save_if(pred):
    from torch.utils.checkpoint import CheckpointPolicy

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if pred(op)
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


_NAMED = {
    "nothing_saveable": None,
    "everything_saveable": lambda: _save_if(lambda op: True),
    "dots_saveable": lambda: _save_if(lambda op: op in _matmul_ops()),
    "dots_with_no_batch_dims_saveable":
        lambda: _save_if(lambda op: op in _matmul_ops()),
}


def _from_callable(fn):
    from torch.utils.checkpoint import CheckpointPolicy

    def policy(ctx, op, *args, **kwargs):
        got = fn(ctx, op, *args, **kwargs)
        if isinstance(got, CheckpointPolicy):
            return got
        return (CheckpointPolicy.MUST_SAVE if got
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def resolve_policy(spec):
    """Map a user remat spec to a selective-checkpoint policy function,
    or None for "recompute everything"."""
    if spec is None or spec is True:
        return None
    if isinstance(spec, str):
        try:
            make = _NAMED[spec]
        except KeyError:
            raise ValueError(
                f"unknown remat policy '{spec}'; see jax.checkpoint_policies")
        return None if make is None else make()
    if callable(spec):
        return _from_callable(spec)
    raise TypeError(f"remat spec must be bool/str/callable, got {type(spec)}")


def checkpointed(fn, spec=True):
    """``fn`` run under ``torch.utils.checkpoint.checkpoint`` with the
    policy of ``spec`` (see :func:`resolve_policy`): the activations
    inside ``fn`` are recomputed in the backward."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    policy = resolve_policy(spec)
    kwargs = {} if policy is None else {
        "context_fn": functools.partial(create_selective_checkpoint_contexts,
                                        policy)}

    @functools.wraps(fn)
    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return run

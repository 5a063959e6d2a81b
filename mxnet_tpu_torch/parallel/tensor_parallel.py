"""Tensor parallelism over a mesh's 'tp' axis (Megatron's layout, which
``mxnet_tpu``'s ``SpecLayout`` rules ask GSPMD for).

``mxnet_tpu`` shards the transformer's projections by ``param_rules``
(``mxnet_tpu/parallel/layout.py:69-124``) and GSPMD places the
collectives. The port runs one process per rank, so a tp rank computes on
its own shards and the collectives are written out:

- a column-parallel product (the qkv projection, the FFN's first layer)
  takes the rank's rows of the weight and bias, behind *f*
  (:func:`collectives.copy_to_tp`: identity forward, all-reduce backward);
- a row-parallel product (the attention output, the FFN's second layer)
  takes the rank's columns of the weight, then *g*
  (:func:`collectives.reduce_from_tp`: all-reduce forward, identity
  backward), then the replicated bias, once.

The qkv projection's rows are [q; k; v], each head's rows inside each
third. A contiguous split of them over tp would give a rank all of q and
part of k, so a rank holds the q, k and v rows of its own heads instead,
in that order (:func:`shard_qkv`): its local qkv output keeps the layout
``MultiHeadAttention`` splits, at ``units / tp`` channels a third.

``ShardedTrainer`` opens a :func:`context` around its forward, naming the
column-parallel layers whose pairs run over tp; a block asks
:func:`running` whether its pair is one of them. Outside the context every
block runs as before.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from . import collectives
from ..ops import nn as _nn

__all__ = ["TPContext", "context", "current", "running", "column_parallel",
           "row_parallel", "shard_qkv", "gather_qkv"]

_LOCAL = threading.local()


class TPContext:
    """A mesh's tp axis and the layers that run over it: ``mesh``,
    ``axis`` (the axis name), ``size`` and ``rank`` (this rank's index
    along it), and ``layers``, the ids of the column-parallel Dense blocks
    whose (column, row) pairs run tensor-parallel."""

    def __init__(self, mesh, axis, layers):
        self.mesh, self.axis = mesh, axis
        self.size = mesh.axis_size(axis)
        self.rank = mesh.axis_index(axis)
        self.layers = frozenset(layers)

    def local(self, n, what):
        """``n`` split over the tp ranks; raises where it does not
        split."""
        if n % self.size:
            raise ValueError(f"tensor parallelism: {what} {n} does not "
                             f"split over tp = {self.size} ranks")
        return n // self.size


@contextlib.contextmanager
def context(ctx):
    """Within this scope (on this thread) the layers ``ctx`` names run
    tensor-parallel over its axis."""
    prev = current()
    _LOCAL.ctx = ctx
    try:
        yield
    finally:
        _LOCAL.ctx = prev


def current():
    """The :class:`TPContext` this thread is in, or None."""
    return getattr(_LOCAL, "ctx", None)


def running(layer):
    """The :class:`TPContext` under which the column-parallel Dense
    ``layer`` (and the row-parallel layer paired with it) runs over tp, or
    None."""
    ctx = current()
    return ctx if ctx is not None and id(layer) in ctx.layers else None


def _required():
    ctx = current()
    if ctx is None:
        raise RuntimeError("tensor parallelism: a column- or row-parallel "
                           "product outside a tp context")
    return ctx


def column_parallel(x, w, b=None):
    """``x @ w.T + b`` on this rank's rows ``w`` (out / tp, in) and ``b``:
    this rank's columns of the output. ``x`` passes *f* first, so its
    gradient is the sum over the tp ranks."""
    ctx = _required()
    return _nn.fully_connected(collectives.copy_to_tp(x, ctx.mesh, ctx.axis),
                               w, b, flatten=False)


def row_parallel(x, w, b=None):
    """``x @ w.T`` on this rank's columns ``w`` (out, in / tp) and of
    ``x``, summed over the tp ranks by *g*, then ``+ b`` (replicated,
    added once; under AMP in the product's dtype, as the unsplit
    ``FullyConnected`` adds it)."""
    ctx = _required()
    y = collectives.reduce_from_tp(_nn.fully_connected(x, w, flatten=False),
                                   ctx.mesh, ctx.axis)
    return y if b is None else y + b.to(y.dtype)


def shard_qkv(full, rank, tp):
    """Rank ``rank``'s head-aligned piece of a qkv projection's ``full``
    weight or bias (dim 0 of 3 * units rows, [q; k; v]): the q, k and v
    rows of its heads, in that order (3 * units / tp rows)."""
    rows = full.shape[0]
    if rows % (3 * tp):
        raise ValueError(f"shard_qkv: {rows} rows do not split into q, k "
                         f"and v over {tp} ranks")
    u = rows // (3 * tp)
    parts = full.reshape((3, tp, u) + tuple(full.shape[1:]))
    return parts[:, rank].reshape((3 * u,) + tuple(full.shape[1:]))


def gather_qkv(pieces):
    """The full qkv weight or bias from the ranks' head-aligned
    ``pieces`` (in rank order): :func:`shard_qkv` undone."""
    tp = len(pieces)
    u = pieces[0].shape[0] // 3
    rest = tuple(pieces[0].shape[1:])
    stacked = torch.stack([p.reshape((3, u) + rest) for p in pieces], dim=1)
    return stacked.reshape((3 * tp * u,) + rest)

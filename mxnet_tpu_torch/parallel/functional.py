"""Gluon net -> functional ``(params, aux, *inputs) -> (outputs, new_aux)``
(port of ``mxnet_tpu/parallel/functional.py``).

``mxnet_tpu`` re-runs a Block with its parameter cells rebound to tracers so
that ``jax.grad`` and ``jit`` see a pure function. The port runs the same
Block through ``torch.func.functional_call``: each MXNet name maps to the
attribute path of the tensor in the module tree (every port ``Parameter``
knows its owning Block and attribute), and the given tensors stand in for
the net's own for the duration of one call.

Two things differ from ``mxnet_tpu`` by construction:

- The call records a graph whenever torch grad mode is on. A Block called
  outside ``autograd.record()`` would otherwise run under
  ``torch.no_grad()`` (``gluon/block.py``); here the forward is recorded
  and in training mode when ``train`` is set, so ``torch.autograd.grad``
  can differentiate it, as ``jax.grad`` traces around the reference.
- BatchNorm writes its running statistics in place (``Parameter.set_data``
  copies into whatever tensor the Block holds). The call therefore clones
  ``aux`` first and returns the clones, updated, as ``new_aux``: the
  caller's ``aux`` dict and the net's own tensors stay as they were, as
  JAX's immutable arrays do.

``mxnet_tpu`` also threads its global PRNG key through ``aux`` under
``RNG_KEY``, for Dropout. The port's ``mx.random`` keeps a generator per
device, not a key, and ResNet has no Dropout, so ``aux_arrays`` holds the
BatchNorm statistics only and no key is faked (a sharded step's Dropout
draws: ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import torch

from .. import autograd
from ..ops import nn as _nn
from . import tensor_parallel

__all__ = ["functional_call", "param_arrays", "aux_arrays"]


def _split_params(net):
    """({name: Parameter} trainable, {name: Parameter} aux), by grad_req,
    as ``mxnet_tpu/parallel/functional.py:24-28`` splits them."""
    params, aux = {}, {}
    for name, p in net._param_objects().items():
        (params if p.grad_req != "null" else aux)[name] = p
    return params, aux


def param_arrays(net):
    """Trainable parameter tensors as a ``{name: tensor}`` dict (the net's
    own tensors, not copies)."""
    return {k: p.data() for k, p in _split_params(net)[0].items()}


def aux_arrays(net):
    """Auxiliary state (BatchNorm running statistics) as ``{name: tensor}``
    (the net's own tensors, not copies)."""
    return {k: p.data() for k, p in _split_params(net)[1].items()}


def _attr_paths(net):
    """MXNet name -> dotted attribute path of its tensor under ``net``."""
    where = {id(m): q for q, m in net.named_modules()}
    paths = {}
    for name, p in net._param_objects().items():
        owner = where.get(id(p._owner))
        if owner is None:
            raise ValueError(f"parameter '{name}' belongs to a Block outside "
                             "this net")
        paths[name] = f"{owner}.{p._attr}" if owner else p._attr
    return paths


def functional_call(net, train=False, mesh=None, batch_axes=(), tp=None):
    """``fn(params, aux, *inputs) -> (outputs, new_aux)``: ``net``'s forward
    with ``params`` and ``aux`` ({name: tensor}, as :func:`param_arrays`
    and :func:`aux_arrays` give them) in place of its own tensors.

    With ``train`` the forward runs in training mode (BatchNorm normalises
    with the batch's statistics) and ``new_aux`` holds the updated running
    statistics; otherwise ``new_aux`` equals ``aux``. ``aux`` itself is not
    written. A name missing from the dicts keeps the net's own tensor.

    ``mesh`` and ``batch_axes``: the inputs are this rank's rows of a batch
    split over the mesh's ``batch_axes``. The training forward then takes
    BatchNorm's moments over the whole batch (their sums all-reduced over
    those axes, differentiably), as ``mxnet_tpu``'s sharded step does, so
    the statistics, their gradient and the running statistics are the
    global batch's.

    ``tp``: a :class:`tensor_parallel.TPContext`, opened around the
    forward; the layers it names then take this rank's tp shards from
    ``params`` and run column- and row-parallel.
    """
    paths = _attr_paths(net)
    ranks = 1 if mesh is None else mesh.axis_size(batch_axes)

    def fn(pvals, avals, *inputs):
        new_aux = {k: v.detach().clone() for k, v in avals.items()}
        tensors = {paths[k]: v for k, v in pvals.items()}
        tensors.update((paths[k], v) for k, v in new_aux.items())
        with autograd._Scope(recording=torch.is_grad_enabled(),
                             training=train), tensor_parallel.context(tp):
            if train and ranks > 1:
                from .collectives import all_reduce_sum_differentiable

                with _nn.sync_batch_stats(
                        lambda t: all_reduce_sum_differentiable(
                            t, mesh, batch_axes), ranks):
                    out = torch.func.functional_call(net, tensors, inputs)
            else:
                out = torch.func.functional_call(net, tensors, inputs)
        return out, new_aux

    return fn

"""Symbolic control flow: ``_foreach``, ``_while_loop``, ``_cond`` (port of
``mxnet_tpu/ops/control_flow.py``; parity: src/operator/control_flow.cc
``_foreach`` :1089, ``_while_loop`` :1150, ``_cond`` :1211).

Each op runs subgraphs that :mod:`mxnet_tpu_torch.symbol.contrib` built
and stashed here: an :class:`~mxnet_tpu_torch.executor.Executor` over the
subgraph, whose :meth:`~mxnet_tpu_torch.executor.Executor.run` walks its
nodes (``mxnet_tpu`` traces them into ``lax.scan`` / ``while_loop`` /
``cond``). The loops are Python loops over tensors, so under autograd
the walk is recorded and a backward reaches through every step; outputs
are stacked, never written into a buffer in place. The op's params carry
only the table key and (subgraph argument position, input index) maps.

Node-input layouts (made by ``symbol/contrib.py``):

  ``_foreach``:    [data..., states..., body frees...]
  ``_while_loop``: [states..., body frees..., cond frees...]
  ``_cond``:       [inputs... (pred's, then's, else's)]

``_while_loop`` and ``_cond`` read their predicate on the host, so they
are registered ``host=True`` and the serving Predictor will not capture
a graph holding them; ``_foreach`` runs a fixed number of steps and can
be captured. On ``meta`` tensors (shape inference) ``_while_loop`` runs
its body once and ``_cond`` its then-branch, to learn the output shapes.
"""
from __future__ import annotations

import itertools

import torch

from ..base import MXNetError
from .registry import register

__all__ = ["stash_subgraph"]

_SUBGRAPHS: dict = {}
_next_id = itertools.count()


def stash_subgraph(executor):
    """Keep the subgraph ``executor`` (no bound arrays); returns its
    table key."""
    key = next(_next_id)
    _SUBGRAPHS[key] = executor
    return key


def _run(key, *maps_and_sources, train, device):
    """The subgraph ``key`` on an argument vector filled from (map,
    sources) pairs, each map a tuple of (argument position, source
    index); its outputs."""
    ex = _SUBGRAPHS[key]
    argv = [None] * len(ex._arg_names)
    for m, src in maps_and_sources:
        for pos, idx in m:
            argv[pos] = src[idx]
    outs, _ = ex.run(argv, [], train, device=device)
    return outs


def _host_bool(t):
    return bool(t.reshape(-1)[0].item())


def _meta(tensors):
    return tuple(torch.empty_like(t, device="meta") for t in tensors)


@register("_foreach", num_outputs=lambda p: p["_n_out"] + p["_n_state"])
def _foreach(*inputs, _sub, _n_data, _n_state, _n_out, _data_map,
             _state_map, _free_map, _train=False, device=None):
    """The subgraph over axis 0 of the data inputs: (*stacked step
    outputs, *final states)."""
    data = inputs[:_n_data]
    states = tuple(inputs[_n_data:_n_data + _n_state])
    free = inputs[_n_data + _n_state:]
    steps = data[0].shape[0]
    if steps == 0:
        raise MXNetError("foreach over zero-length data: the output shapes "
                         "are unknown")
    ys = [[] for _ in range(_n_out)]
    for i in range(steps):
        outs = _run(_sub, (_data_map, [d[i] for d in data]),
                    (_state_map, states), (_free_map, free), train=_train,
                    device=device)
        for k in range(_n_out):
            ys[k].append(outs[k])
        states = tuple(outs[_n_out:])
    return (*(torch.stack(y) for y in ys), *states)


@register("_while_loop", host=True,
          num_outputs=lambda p: p["_n_out"] + p["_n_state"])
def _while_loop(*inputs, _cond_sub, _body_sub, _n_state, _n_body_free,
                _n_out, _max_iterations, _body_state_map, _body_free_map,
                _cond_state_map, _cond_free_map, _train=False, device=None):
    """Run the body while the condition holds, at most
    ``_max_iterations`` times; the step outputs stacked and padded with
    zero rows to ``_max_iterations`` (as MXNet pads): (*outputs, *final
    states)."""
    states = tuple(inputs[:_n_state])
    body_free = inputs[_n_state:_n_state + _n_body_free]
    cond_free = inputs[_n_state + _n_body_free:]

    def body(carry, free, dev):
        outs = _run(_body_sub, (_body_state_map, carry),
                    (_body_free_map, free), train=_train, device=dev)
        return outs[:_n_out], tuple(outs[_n_out:])

    def probe():
        return body(_meta(states), _meta(body_free), "meta")[0]

    if any(t.device.type == "meta" for t in inputs):
        return (*(torch.empty((_max_iterations,) + tuple(o.shape),
                              dtype=o.dtype, device="meta")
                  for o in probe()), *states)
    ys = [[] for _ in range(_n_out)]
    steps = 0
    while steps < _max_iterations and _host_bool(_run(
            _cond_sub, (_cond_state_map, states), (_cond_free_map, cond_free),
            train=_train, device=device)[0]):
        outs, states = body(states, body_free, device)
        for k in range(_n_out):
            ys[k].append(outs[k])
        steps += 1
    like = [y[0] for y in ys] if steps else probe()
    bufs = []
    for y, o in zip(ys, like):
        pad = torch.zeros((_max_iterations - steps,) + tuple(o.shape),
                          dtype=o.dtype, device=device or inputs[0].device)
        bufs.append(torch.cat([torch.stack(y), pad]) if y else pad)
    return (*bufs, *states)


@register("_cond", host=True, num_outputs=lambda p: p["_n_out"])
def _cond(*inputs, _pred_sub, _then_sub, _else_sub, _pred_map, _then_map,
          _else_map, _n_out, _train=False, device=None):
    """The then-subgraph's outputs where the predicate subgraph's first
    element is non-zero, else the else-subgraph's."""
    if any(t.device.type == "meta" for t in inputs):
        taken = True
    else:
        taken = _host_bool(_run(_pred_sub, (_pred_map, inputs),
                                train=_train, device=device)[0])
    sub, m = (_then_sub, _then_map) if taken else (_else_sub, _else_map)
    outs = _run(sub, (m, inputs), train=_train, device=device)[:_n_out]
    return tuple(outs) if len(outs) > 1 else outs[0]

"""Functional optimizers for ``ShardedTrainer`` (port of
``mxnet_tpu/parallel/optim.py``).

``make_update_fn(optimizer, optimizer_params) -> (init, update)`` over
``{name: tensor}`` dicts with a step counter ``t``, keyed by the same
aliases as ``optimizer.create``. The arithmetic is that of the per-parameter
ops in :mod:`mxnet_tpu_torch.ops.optimizer_ops`, with one ``wd`` for every
name (``mxnet_tpu/parallel/optim.py:38-44``): unlike ``gluon.Trainer``'s
optimizer built from ``param_idx2name``, nothing here exempts biases or
BatchNorm's gamma and beta.

Where ``mxnet_tpu`` returns new arrays, the port updates the weight and
state tensors in place (the trainer owns them; updating in place keeps one
copy of 25 M ResNet-50 weights instead of two) and returns the same dicts.
Each optimizer runs as one multi-tensor op of
:mod:`mxnet_tpu_torch.ops.optimizer_ops` over every tensor, a few
``torch._foreach_*`` launches a step in place of several per parameter,
element for element the arithmetic of the per-parameter ops (a CPU test
holds the two bitwise equal). ``lr``, ``wd`` and ``rescale_grad`` are
scalar operands computed on the host each step, so a captured step reads
them from device slots and a new rate or bias correction never
re-captures. Ported: ``"sgd"`` / ``"lbsgd"`` and ``"adam"``; the other
names of ``mxnet_tpu``'s registry are queued (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import math

import torch

from ..ops import optimizer_ops as _ops

__all__ = ["make_update_fn", "FUNCTIONAL_OPTIMIZERS"]

FUNCTIONAL_OPTIMIZERS = {}


def _register(*names):
    def deco(factory):
        for n in names:
            FUNCTIONAL_OPTIMIZERS[n] = factory
        return factory
    return deco


def _hyper(kw, default_lr):
    return {
        "lr": kw.pop("learning_rate", default_lr),
        "wd": kw.pop("wd", 0.0),
        "rescale_grad": kw.pop("rescale_grad", 1.0),
        "clip_gradient": kw.pop("clip_gradient", None),
    }


def _check_empty(name, kw):
    if kw:
        raise ValueError(f"functional optimizer '{name}': unknown "
                         f"parameters {sorted(kw)}")


# Each factory(optimizer_params) returns (init_one, scalars, apply):
#   init_one(name, w) -> per-param state (a tensor, a tuple of them, or ()),
#   scalars(t) -> [lr, wd, rescale_grad] as Python floats for the 1-based
#   step t (Adam's bias correction folded into lr, as mxnet_tpu does),
#   apply(ws, gs, ss, scal) -> None: updates the lists of weights and states
#   in place with scal = [lr, wd, rescale_grad], each a float or a 0-d
#   float32 tensor on the weights' device (a captured step's slots).

def _fixed_scalars(h):
    return lambda t: [h["lr"], h["wd"], h["rescale_grad"]]


@_register("sgd", "lbsgd")
def _sgd(kw):
    h = _hyper(kw, 0.01)
    momentum = kw.pop("momentum", 0.0)
    _check_empty("sgd", kw)
    clip = h["clip_gradient"]

    def apply(ws, gs, ss, scal):
        lr, wd, rescale = scal
        if momentum == 0.0:
            _ops.multi_sgd_update(ws, gs, lr, wd, rescale, clip)
        else:
            _ops.multi_sgd_mom_update(ws, gs, ss, lr, wd, momentum, rescale,
                                      clip)

    if momentum == 0.0:
        return (lambda n, w: ()), _fixed_scalars(h), apply
    return (lambda n, w: torch.zeros_like(w)), _fixed_scalars(h), apply


@_register("adam")
def _adam(kw):
    h = _hyper(kw, 0.001)
    beta1 = kw.pop("beta1", 0.9)
    beta2 = kw.pop("beta2", 0.999)
    epsilon = kw.pop("epsilon", 1e-8)
    _check_empty("adam", kw)

    def scalars(t):
        # bias correction folded into the rate at step t
        # (mxnet_tpu/parallel/optim.py:97-99)
        lr_t = h["lr"] * math.sqrt(1 - beta2 ** t) / (1 - beta1 ** t)
        return [lr_t, h["wd"], h["rescale_grad"]]

    def apply(ws, gs, ss, scal):
        lr, wd, rescale = scal
        _ops.multi_adam_update(ws, gs, [s[0] for s in ss], [s[1] for s in ss],
                               lr, wd, beta1, beta2, epsilon, rescale,
                               h["clip_gradient"])

    return ((lambda n, w: (torch.zeros_like(w), torch.zeros_like(w))),
            scalars, apply)


def make_update_fn(optimizer="sgd", optimizer_params=None):
    """``(init, update)`` for a whole ``{name: tensor}`` param dict.

    ``init(params) -> opt_state``: ``{"t": 0, "state": {name: state}}``.
    ``update(params, grads, opt_state) -> (params, opt_state)``: one step,
    applied in place to ``params`` and the state tensors, ``t`` advanced.
    Its scalars are ``update.scalars(t)`` (Python floats) unless
    ``opt_state["scalars"]`` holds them, as a captured step's device slots.
    """
    factory = FUNCTIONAL_OPTIMIZERS.get(optimizer)
    if factory is None:
        raise ValueError(
            f"unsupported sharded optimizer '{optimizer}'; functional "
            f"registry has: {sorted(FUNCTIONAL_OPTIMIZERS)} (the other "
            "names of mxnet_tpu's registry are queued: ROADMAP Queue 1 "
            "item 5)")
    init_one, scalars, apply = factory(dict(optimizer_params or {}))

    def init(params):
        return {"t": 0,
                "state": {k: init_one(k, v) for k, v in params.items()}}

    def update(params, grads, opt_state):
        t = opt_state["t"] + 1
        names = list(params)
        scal = opt_state.get("scalars") or scalars(t)
        apply([params[k] for k in names], [grads[k] for k in names],
              [opt_state["state"][k] for k in names], scal)
        opt_state["t"] = t
        return params, opt_state

    update.scalars = scalars
    return init, update

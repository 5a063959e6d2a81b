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
SGD runs as one group of ``torch._foreach_*`` ops over every tensor, a few
launches a step in place of several per parameter, element for element the
arithmetic of ``sgd_update`` / ``sgd_mom_update`` (a CPU test holds the two
bitwise equal). Ported: ``"sgd"`` / ``"lbsgd"`` and ``"adam"``; the other
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


# Each factory(optimizer_params) returns (init_one, update_group):
#   init_one(name, w) -> per-param state (a tensor, a tuple of them, or ()),
#   update_group(ws, gs, ss, t) -> None: updates the lists of weights and
#   states in place; t is the 1-based step count (a Python int).

@_register("sgd", "lbsgd")
def _sgd(kw):
    h = _hyper(kw, 0.01)
    momentum = kw.pop("momentum", 0.0)
    _check_empty("sgd", kw)
    lr, wd = h["lr"], h["wd"]
    rescale, clip = h["rescale_grad"], h["clip_gradient"]

    @torch.no_grad()
    def update(ws, gs, ss, t):
        # g = clip(grad * rescale); step = lr * (g + wd * w), as
        # optimizer_ops.sgd_update / sgd_mom_update compute it
        g = torch._foreach_mul(gs, rescale)
        if clip is not None and clip >= 0:
            torch._foreach_clamp_min_(g, -clip)
            torch._foreach_clamp_max_(g, clip)
        step = torch._foreach_mul(ws, wd)
        torch._foreach_add_(step, g)
        torch._foreach_mul_(step, lr)
        if momentum == 0.0:
            torch._foreach_sub_(ws, step)
            return
        torch._foreach_mul_(ss, momentum)
        torch._foreach_sub_(ss, step)
        torch._foreach_add_(ws, ss)

    if momentum == 0.0:
        return (lambda n, w: ()), update
    return (lambda n, w: torch.zeros_like(w)), update


@_register("adam")
def _adam(kw):
    h = _hyper(kw, 0.001)
    beta1 = kw.pop("beta1", 0.9)
    beta2 = kw.pop("beta2", 0.999)
    epsilon = kw.pop("epsilon", 1e-8)
    _check_empty("adam", kw)
    base_lr = h.pop("lr")

    def update(ws, gs, ss, t):
        # bias correction folded into the rate at step t
        # (mxnet_tpu/parallel/optim.py:97-99)
        lr_t = base_lr * math.sqrt(1 - beta2 ** t) / (1 - beta1 ** t)
        for w, g, (m, v) in zip(ws, gs, ss):
            _ops.adam_update(w, g, m, v, lr=lr_t, beta1=beta1, beta2=beta2,
                             epsilon=epsilon, **h)

    return (lambda n, w: (torch.zeros_like(w), torch.zeros_like(w))), update


def make_update_fn(optimizer="sgd", optimizer_params=None):
    """``(init, update)`` for a whole ``{name: tensor}`` param dict.

    ``init(params) -> opt_state``: ``{"t": 0, "state": {name: state}}``.
    ``update(params, grads, opt_state) -> (params, opt_state)``: one step,
    applied in place to ``params`` and the state tensors, ``t`` advanced.
    """
    factory = FUNCTIONAL_OPTIMIZERS.get(optimizer)
    if factory is None:
        raise ValueError(
            f"unsupported sharded optimizer '{optimizer}'; functional "
            f"registry has: {sorted(FUNCTIONAL_OPTIMIZERS)} (the other "
            "names of mxnet_tpu's registry are queued: ROADMAP Queue 1 "
            "item 5)")
    init_one, update_group = factory(dict(optimizer_params or {}))

    def init(params):
        return {"t": 0,
                "state": {k: init_one(k, v) for k, v in params.items()}}

    def update(params, grads, opt_state):
        t = opt_state["t"] + 1
        names = list(params)
        update_group([params[k] for k in names], [grads[k] for k in names],
                     [opt_state["state"][k] for k in names], t)
        opt_state["t"] = t
        return params, opt_state

    return init, update

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
re-captures; what the step count sets beyond Adam's folded rate (Adamax's
rate, Nadam's momenta, FTML's and LAMB's corrections) follows them as
scalars of its own. Every name of ``mxnet_tpu``'s registry is ported:
``sgd`` / ``lbsgd``, ``nag``, ``adam``, ``adamw``, ``ftrl``, ``rmsprop``,
``adagrad``, ``adadelta``, ``adamax``, ``nadam``, ``ftml``, ``signum``,
``lamb``, ``lars``, ``dcasgd`` and ``sgld``. SGD, Adam and LAMB update
the group as one multi-tensor op, the others weight by weight. ``sgld``
draws its noise from ``generator`` (a ``torch.Generator`` on the
parameters' device, in ``optimizer_params``; the global stream when
absent): ``mxnet_tpu`` draws it from a JAX key per parameter name, whose
bits torch cannot repeat.
"""
from __future__ import annotations

import math

import numpy as np
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
#   scalars(t) -> [lr, wd, rescale_grad, ...] as Python floats for the
#   1-based step t (Adam's bias correction folded into lr, as mxnet_tpu
#   does; what else t sets follows),
#   apply(ws, gs, ss, scal) -> None: updates the lists of weights and states
#   in place with scal = scalars(t)'s values, each a float or a 0-d
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


def _zeros(n, w):
    return torch.zeros_like(w)


def _zeros2(n, w):
    return (torch.zeros_like(w), torch.zeros_like(w))


def _rc(g, h, rescale):
    """``g * rescale`` clipped when ``clip_gradient`` is set
    (``mxnet_tpu/parallel/optim.py:47-51``)."""
    g = g * rescale
    c = h["clip_gradient"]
    return g if c is None else torch.clamp(g, -c, c)


def _per_weight(step):
    """``apply`` running ``step(w, g, s, scal)`` under no_grad on each
    weight."""
    @torch.no_grad()
    def apply(ws, gs, ss, scal):
        for w, g, s in zip(ws, gs, ss):
            step(w, g, s, scal)
    return apply


@_register("nag")
def _nag(kw):
    h = _hyper(kw, 0.01)
    momentum = kw.pop("momentum", 0.0)
    _check_empty("nag", kw)

    def step(w, g, s, scal):
        lr, wd, rescale = scal
        _ops.nag_mom_update(w, g, s, lr, momentum, wd, rescale,
                            h["clip_gradient"])
    return _zeros, _fixed_scalars(h), _per_weight(step)


@_register("adamw")
def _adamw(kw):
    h = _hyper(kw, 0.001)
    beta1 = kw.pop("beta1", 0.9)
    beta2 = kw.pop("beta2", 0.999)
    epsilon = kw.pop("epsilon", 1e-8)
    eta = kw.pop("eta", 1.0)
    _check_empty("adamw", kw)

    def step(w, g, s, scal):
        lr, wd, rescale = scal
        _ops.adamw_update(w, g, s[0], s[1], lr=lr, beta1=beta1, beta2=beta2,
                          epsilon=epsilon, wd=wd, eta=eta,
                          rescale_grad=rescale,
                          clip_gradient=h["clip_gradient"])
    return _zeros2, _fixed_scalars(h), _per_weight(step)


@_register("ftrl")
def _ftrl(kw):
    h = _hyper(kw, 0.1)
    lamda1 = kw.pop("lamda1", 0.01)
    beta = kw.pop("beta", 1.0)
    _check_empty("ftrl", kw)

    def step(w, g, s, scal):
        lr, wd, rescale = scal
        _ops.ftrl_update(w, g, s[0], s[1], lr=lr, lamda1=lamda1, beta=beta,
                         wd=wd, rescale_grad=rescale,
                         clip_gradient=h["clip_gradient"])
    return _zeros2, _fixed_scalars(h), _per_weight(step)


@_register("rmsprop")
def _rmsprop(kw):
    h = _hyper(kw, 0.001)
    gamma1 = kw.pop("gamma1", 0.9)
    gamma2 = kw.pop("gamma2", 0.9)
    epsilon = kw.pop("epsilon", 1e-8)
    centered = kw.pop("centered", False)
    _check_empty("rmsprop", kw)

    def step(w, g, s, scal):
        lr, wd, rescale = scal
        k = {"lr": lr, "epsilon": epsilon, "wd": wd, "rescale_grad": rescale,
             "clip_gradient": h["clip_gradient"]}
        if centered:
            _ops.rmspropalex_update(w, g, *s, gamma1=gamma1, gamma2=gamma2,
                                    **k)
        else:
            _ops.rmsprop_update(w, g, s, gamma1=gamma1, **k)
    init = (lambda n, w: tuple(torch.zeros_like(w) for _ in range(3))) \
        if centered else _zeros
    return init, _fixed_scalars(h), _per_weight(step)


@_register("adagrad")
def _adagrad(kw):
    h = _hyper(kw, 0.01)
    eps = kw.pop("eps", 1e-7)
    _check_empty("adagrad", kw)

    def step(w, g, s, scal):
        lr, wd, rescale = scal
        g = _rc(g, h, rescale) + wd * w
        s.add_(g * g)
        w.sub_(lr * g / (torch.sqrt(s) + eps))
    return _zeros, _fixed_scalars(h), _per_weight(step)


@_register("adadelta")
def _adadelta(kw):
    h = _hyper(kw, 1.0)
    rho = kw.pop("rho", 0.9)
    epsilon = kw.pop("epsilon", 1e-5)
    _check_empty("adadelta", kw)

    def step(w, g, s, scal):
        lr, wd, rescale = scal
        acc_g, acc_d = s
        g = _rc(g, h, rescale) + wd * w
        acc_g.mul_(rho).add_((1 - rho) * (g * g))
        delta = torch.sqrt(acc_d + epsilon) / torch.sqrt(acc_g + epsilon) * g
        acc_d.mul_(rho).add_((1 - rho) * (delta * delta))
        w.sub_(lr * delta)
    return _zeros2, _fixed_scalars(h), _per_weight(step)


@_register("adamax")
def _adamax(kw):
    h = _hyper(kw, 0.002)
    beta1 = kw.pop("beta1", 0.9)
    beta2 = kw.pop("beta2", 0.999)
    _check_empty("adamax", kw)

    def scalars(t):
        return [h["lr"] / (1 - beta1 ** t), h["wd"], h["rescale_grad"]]

    def step(w, g, s, scal):
        lr_t, wd, rescale = scal
        m, u = s
        g = _rc(g, h, rescale) + wd * w
        m.mul_(beta1).add_((1 - beta1) * g)
        torch.maximum(beta2 * u, torch.abs(g), out=u)
        w.sub_(lr_t * m / (u + 1e-8))
    return _zeros2, scalars, _per_weight(step)


@_register("nadam")
def _nadam(kw):
    h = _hyper(kw, 0.001)
    beta1 = kw.pop("beta1", 0.9)
    beta2 = kw.pop("beta2", 0.999)
    epsilon = kw.pop("epsilon", 1e-8)
    schedule_decay = kw.pop("schedule_decay", 0.004)
    _check_empty("nadam", kw)

    def momentum_t(t):
        return beta1 * (1 - 0.5 * 0.96 ** (t * schedule_decay))

    def scalars(t):
        # the momentum schedule's t-th and (t+1)-th factors, 1 - beta2^t
        return [h["lr"], h["wd"], h["rescale_grad"], momentum_t(t),
                momentum_t(t + 1), 1 - beta2 ** t]

    def step(w, g, s, scal):
        lr, wd, rescale, mt, mt1, c2 = scal
        m, v, sched = s
        g = _rc(g, h, rescale) + wd * w
        sched.mul_(mt)
        m.mul_(beta1).add_((1 - beta1) * g)
        v.mul_(beta2).add_((1 - beta2) * (g * g))
        m_bar = (1 - mt) * (g / (1 - sched)) + mt1 * (m / (1 - sched * mt1))
        w.sub_(lr * m_bar / (torch.sqrt(v / c2) + epsilon))
    return ((lambda n, w: (torch.zeros_like(w), torch.zeros_like(w),
                           torch.ones((), dtype=w.dtype, device=w.device))),
            scalars, _per_weight(step))


def _pow_f32(base, t):
    """``base ** t`` for an integer ``t`` in float32 by repeated squaring,
    as XLA raises a float to a traced int32 power."""
    acc, x = np.float32(1), np.float32(base)
    while t > 0:
        if t & 1:
            acc = np.float32(acc * x)
        x = np.float32(x * x)
        t >>= 1
    return acc


@_register("ftml")
def _ftml(kw):
    h = _hyper(kw, 0.0025)
    beta1 = kw.pop("beta1", 0.6)
    beta2 = kw.pop("beta2", 0.999)
    epsilon = kw.pop("epsilon", 1e-8)
    _check_empty("ftml", kw)

    def scalars(t):
        # in float32, as mxnet_tpu's traced step count computes them: 1 -
        # beta2^t cancels (an ulp of beta2^t is 2e-5 of it at t = 3), and
        # the port takes the reference's value, not a more exact one
        one = np.float32(1)
        return [h["lr"], h["wd"], h["rescale_grad"],
                float((one - _pow_f32(beta1, t)) / np.float32(h["lr"])),
                float(one - _pow_f32(beta2, t))]

    def step(w, g, s, scal):
        _, wd, rescale, k, c2 = scal
        # clipped before the decay is added, as mxnet_tpu's functional
        # FTML does (its op clips after)
        g = _rc(g, h, rescale) + wd * w
        _ops.ftml_step(w, g, *s, k, c2, beta1, beta2, epsilon)
    return ((lambda n, w: tuple(torch.zeros_like(w) for _ in range(3))),
            scalars, _per_weight(step))


@_register("signum")
def _signum(kw):
    h = _hyper(kw, 0.01)
    momentum = kw.pop("momentum", 0.9)
    wd_lh = kw.pop("wd_lh", 0.0)
    _check_empty("signum", kw)

    def step(w, g, s, scal):
        lr, wd, rescale = scal
        if momentum == 0.0:
            _ops.signsgd_update(w, g, lr, wd, rescale, h["clip_gradient"])
        else:
            _ops.signum_update(w, g, s, lr, momentum, wd, rescale,
                               h["clip_gradient"], wd_lh)
    init = (lambda n, w: ()) if momentum == 0.0 else _zeros
    return init, _fixed_scalars(h), _per_weight(step)


@_register("lamb")
def _lamb(kw):
    h = _hyper(kw, 0.001)
    beta1 = kw.pop("beta1", 0.9)
    beta2 = kw.pop("beta2", 0.999)
    epsilon = kw.pop("epsilon", 1e-6)
    lower_bound = kw.pop("lower_bound", -1.0)
    upper_bound = kw.pop("upper_bound", -1.0)
    bias_correction = kw.pop("bias_correction", True)
    _check_empty("lamb", kw)

    def scalars(t):
        return [h["lr"], h["wd"], h["rescale_grad"], 1 - beta1 ** t,
                1 - beta2 ** t]

    def apply(ws, gs, ss, scal):
        lr, wd, rescale, c1, c2 = scal
        _ops.multi_lamb_update(
            ws, gs, [s[0] for s in ss], [s[1] for s in ss], lr, wd, beta1,
            beta2, epsilon, rescale, h["clip_gradient"],
            [(c1, c2)] * len(ws) if bias_correction else None, lower_bound,
            upper_bound)
    return _zeros2, scalars, apply


@_register("lars")
def _lars(kw):
    h = _hyper(kw, 0.1)
    momentum = kw.pop("momentum", 0.9)
    eta = kw.pop("eta", 0.001)
    epsilon = kw.pop("epsilon", 1e-8)
    _check_empty("lars", kw)

    def step(w, g, s, scal):
        lr, wd, rescale = scal
        g = _rc(g, h, rescale)
        w_norm = torch.linalg.vector_norm(w)
        g_norm = torch.linalg.vector_norm(g)
        trust = torch.where(
            (w_norm > 0) & (g_norm > 0),
            eta * w_norm / (g_norm + wd * w_norm + epsilon),
            torch.ones_like(w_norm))
        s.mul_(momentum).add_(lr * trust * (g + wd * w))
        w.sub_(s)
    return _zeros, _fixed_scalars(h), _per_weight(step)


@_register("dcasgd")
def _dcasgd(kw):
    h = _hyper(kw, 0.1)
    momentum = kw.pop("momentum", 0.0)
    lamda = kw.pop("lamda", 0.04)
    _check_empty("dcasgd", kw)

    def step(w, g, s, scal):
        lr, wd, rescale = scal
        mom, prev_w = s
        g = _rc(g, h, rescale) + wd * w
        comp = g + lamda * g * g * (w - prev_w)
        mom.mul_(momentum).sub_(lr * comp)
        w.add_(mom)
        prev_w.copy_(w)
    return ((lambda n, w: (torch.zeros_like(w), w.detach().clone())),
            _fixed_scalars(h), _per_weight(step))


@_register("sgld")
def _sgld(kw):
    h = _hyper(kw, 0.01)
    generator = kw.pop("generator", None)
    _check_empty("sgld", kw)
    from ..optimizer.optimizer import _normal

    def step(w, g, s, scal):
        lr, wd, rescale = scal
        g = _rc(g, h, rescale) + wd * w
        w.copy_(w - 0.5 * lr * g + _normal(w, _ops._sqrt(lr), generator))
    return (lambda n, w: ()), _fixed_scalars(h), _per_weight(step)


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
            f"registry has: {sorted(FUNCTIONAL_OPTIMIZERS)}")
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

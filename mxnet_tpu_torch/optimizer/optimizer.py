"""Optimizers (port of ``mxnet_tpu/optimizer/optimizer.py``; parity:
python/mxnet/optimizer/optimizer.py): SGD, NAG, Adam, AdamW, AdaGrad,
AdaDelta, RMSProp, Ftrl, Adamax, Nadam, Signum, SGLD, DCASGD, FTML, LAMB,
LARS, LBSGD and Test, under their lower-cased names for :func:`create`.

An :class:`Optimizer` holds the hyper-parameters and the per-index update
counts; its update runs ops of :mod:`mxnet_tpu_torch.ops.optimizer_ops`,
which write the weight and the state tensors in place. States are zeros in
the weight's dtype on its device. ``multi_precision`` keeps a float32
master of every float16 weight, as in the reference (a bf16 net trains with
bf16 weights and states). ``lr_scheduler`` takes a scheduler of
:mod:`mxnet_tpu_torch.lr_scheduler` (or any callable of the update count
with a ``base_lr``), which gives the rate at every update.

An update is two parts: :meth:`Optimizer._scalars` advances the update
counts and gives the index's ``n_scalars`` scalars as Python floats --
``lr`` and ``wd`` first, then what the step count sets (Adam's and
Adamax's bias corrections are folded into ``lr``; LAMB's, Nadam's and
FTML's are scalars of their own) -- and :meth:`Optimizer.apply` runs the
update over a group of weights with those scalars, given as floats or as
0-d device tensors ("slots"). ``gluon.Trainer`` runs its whole sweep as
one :meth:`Optimizer.update_group`: one multi-tensor op for SGD, Adam and
LAMB, per-weight ops for the others; a captured step
(:mod:`mxnet_tpu_torch.capture`) runs the first part on the host every
step and writes its values into the slots its graph reads.

Where ``mxnet_tpu`` differs from MXNet the port follows MXNet (ROADMAP
Queue 3): the fp16 ``multi_precision`` SGD counts its update before it
reads the rate, as every other update does.

Weight decay: ``wd`` times the parameter's ``wd_mult``. Through
``gluon.Trainer`` every parameter's ``wd_mult`` comes from its Parameter
(1.0 unless set), biases and BatchNorm's gamma and beta included, as in
``mxnet_tpu``; the zero default for names ending in ``_bias``, ``_gamma``
or ``_beta`` applies where the optimizer is built with ``param_idx2name``
and no ``param_dict``.

:meth:`Updater.get_states` / :meth:`Updater.set_states` write and read
``mxnet_tpu``'s bytes: a pickle of ``{index: numpy array, tuple of them or
None, "__update_counts__": {index: t}}``. A bfloat16 state is written as
``mxnet_tpu`` writes one, an ``ml_dtypes`` bfloat16 array, and read back
bit for bit, without importing ``ml_dtypes`` (:func:`_dumps_states`,
:func:`_loads_states`).
"""
from __future__ import annotations

import io
import math
import pickle

import numpy as _np
import torch

from ..base import MXNetError
from ..ops import optimizer_ops as _ops

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "AdaGrad", "AdaDelta",
           "RMSProp", "Ftrl", "Adamax", "Nadam", "Signum", "SGLD", "DCASGD",
           "FTML", "LAMB", "LARS", "LBSGD", "Test", "Updater", "get_updater",
           "create", "register"]

_REGISTRY = {}


def register(klass):
    """Register an Optimizer class under its lower-cased name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """The registered optimizer ``name`` (any case) built with ``kwargs``."""
    try:
        klass = _REGISTRY[name.lower()]
    except KeyError:
        raise MXNetError(f"optimizer '{name}' is not registered. Known: "
                         f"{sorted(_REGISTRY)}") from None
    return klass(**kwargs)


class Optimizer:
    """Base optimizer (``mxnet_tpu/optimizer/optimizer.py:35-143``).

    Learning-rate and weight-decay multipliers come from ``param_dict``
    (index -> Parameter, whose ``lr_mult`` / ``wd_mult`` count), else from
    ``set_lr_mult`` / ``set_wd_mult`` by index or by name; names ending in
    ``_bias``, ``_gamma`` or ``_beta`` get no weight decay by default.
    """

    #: scalars a weight's update takes (``_scalars``): lr, wd, ...
    n_scalars = 2

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False, param_dict=None,
                 aggregate_num=0, **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}
        self.set_wd_mult({})
        # accepted for parity (mxnet_tpu/optimizer/optimizer.py:62-66):
        # gluon.Trainer always updates every weight in one update_group
        self.aggregate_num = int(aggregate_num)

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if self._is_mp(weight):
            w32 = weight.detach().float()
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    def _scalars(self, index):
        """Advance ``index``'s update count; its ``n_scalars`` scalars for
        this update as Python floats, ``(lr, wd)`` here."""
        self._update_count(index)
        return self._get_lr(index), self._get_wd(index)

    def apply(self, weights, grads, states, scal, rescale_grad):
        """One update of ``weights`` in place: ``scal`` holds each weight's
        scalars (a tuple of ``n_scalars``) and ``rescale_grad`` one for
        all, each a float or a 0-d float32 tensor on the weights' device.
        Here each weight goes through :meth:`_one`."""
        for w, g, s, sc in zip(weights, grads, states, scal):
            self._one(w, g, s, sc, rescale_grad)

    def _one(self, weight, grad, state, scal, rescale_grad):
        raise NotImplementedError

    def update(self, index, weight, grad, state):
        self.apply([weight], [grad], [state], [self._scalars(index)],
                   self.rescale_grad)

    def _is_mp(self, weight):
        return self.multi_precision and weight.dtype == torch.float16

    def update_multi_precision(self, index, weight, grad, state):
        self.update_group([weight], [grad], [state], [self._scalars(index)],
                          self.rescale_grad)

    def update_group(self, weights, grads, states, scal, rescale_grad):
        """:meth:`apply` over a group, fp16 weights with ``multi_precision``
        updated through their float32 masters one at a time."""
        plain = []
        for k, (w, g, s) in enumerate(zip(weights, grads, states)):
            if not self._is_mp(w):
                plain.append(k)
                continue
            inner_state, w32 = s
            self.apply([w32], [g.float()], [inner_state], [scal[k]],
                       rescale_grad)
            with torch.no_grad():
                w.copy_(w32)
        if plain:
            self.apply([weights[k] for k in plain], [grads[k] for k in plain],
                       [states[k] for k in plain], [scal[k] for k in plain],
                       rescale_grad)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("lr_scheduler is set; use it to change the rate")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)
        for name in self.idx2name.values():
            if name.endswith(("_bias", "_gamma", "_beta")) and \
                    name not in self.wd_mult:
                self.wd_mult[name] = 0.0

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _mult(self, index, table, attr):
        name = self.idx2name.get(index, index)
        if name in self.param_dict:
            return getattr(self.param_dict[name], attr, 1.0)
        if index in table:
            return table[index]
        return table.get(name, 1.0)

    def _get_lr(self, index):
        lr = (self.lr_scheduler(self.num_update) if self.lr_scheduler
              else self.lr)
        return lr * self._mult(index, self.lr_mult, "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._mult(index, self.wd_mult, "wd_mult")

    def _clip(self, g):
        """``g`` clipped to ``[-clip_gradient, clip_gradient]`` when that is
        set (the reference's ``nd.clip`` in the Python-side updates)."""
        c = self.clip_gradient
        return g if c is None else torch.clamp(g, -c, c)


def _zeros_like(weight):
    return torch.zeros_like(weight, memory_format=torch.contiguous_format)


def _lrs_wds(scal):
    return [s[0] for s in scal], [s[1] for s in scal]


@register
class SGD(Optimizer):
    """SGD with optional momentum (``optimizer.py:147-183``): the fused
    ``multi_sgd_update`` / ``multi_sgd_mom_update``."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def apply(self, weights, grads, states, scal, rescale_grad):
        lrs, wds = _lrs_wds(scal)
        if self.momentum != 0.0:
            _ops.multi_sgd_mom_update(weights, grads, states, lrs, wds,
                                      self.momentum, rescale_grad,
                                      self.clip_gradient)
        else:
            _ops.multi_sgd_update(weights, grads, lrs, wds, rescale_grad,
                                  self.clip_gradient)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (``optimizer.py:186-205``):
    ``nag_mom_update``, or ``sgd_update`` without momentum."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def _one(self, weight, grad, state, scal, rescale_grad):
        lr, wd = scal
        if state is not None:
            _ops.nag_mom_update(weight, grad, state, lr, self.momentum, wd,
                                rescale_grad, self.clip_gradient)
        else:
            _ops.sgd_update(weight, grad, lr, wd, rescale_grad,
                            self.clip_gradient)


@register
class Adam(Optimizer):
    """Adam (``optimizer.py:208-227``): the bias correction is folded into
    the learning rate, ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)``, then
    the fused ``multi_adam_update``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _scalars(self, index):
        lr, wd = super()._scalars(index)
        t = self._index_update_count[index]
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        return lr, wd

    def apply(self, weights, grads, states, scal, rescale_grad):
        lrs, wds = _lrs_wds(scal)
        _ops.multi_adam_update(weights, grads, [s[0] for s in states],
                               [s[1] for s in states], lrs, wds, self.beta1,
                               self.beta2, self.epsilon, rescale_grad,
                               self.clip_gradient)


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay (``optimizer.py:230-246``):
    ``adamw_update``, no bias correction, as there."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, eta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon, self.eta = epsilon, eta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _one(self, weight, grad, state, scal, rescale_grad):
        lr, wd = scal
        _ops.adamw_update(weight, grad, state[0], state[1], lr=lr,
                          beta1=self.beta1, beta2=self.beta2,
                          epsilon=self.epsilon, wd=wd, eta=self.eta,
                          rescale_grad=rescale_grad,
                          clip_gradient=self.clip_gradient)


@register
class AdaGrad(Optimizer):
    """AdaGrad (``optimizer.py:249-266``)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    @torch.no_grad()
    def _one(self, weight, grad, state, scal, rescale_grad):
        lr, wd = scal
        g = self._clip(grad * rescale_grad)
        state.add_(g * g)
        delta = g / (torch.sqrt(state) + self.float_stable_eps) + wd * weight
        weight.sub_(lr * delta)


@register
class AdaDelta(Optimizer):
    """AdaDelta (``optimizer.py:269-290``): no learning rate."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    @torch.no_grad()
    def _one(self, weight, grad, state, scal, rescale_grad):
        _, wd = scal
        g = self._clip(grad * rescale_grad)
        acc_g, acc_delta = state
        acc_g.mul_(self.rho).add_((1 - self.rho) * g * g)
        cur = (torch.sqrt(acc_delta + self.epsilon)
               / torch.sqrt(acc_g + self.epsilon)) * g
        acc_delta.mul_(self.rho).add_((1 - self.rho) * cur * cur)
        weight.copy_((1 - wd) * weight - cur)


@register
class RMSProp(Optimizer):
    """RMSProp, plain or centered (``optimizer.py:293-318``):
    ``rmsprop_update`` / ``rmspropalex_update``."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered, self.epsilon = centered, epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return tuple(_zeros_like(weight) for _ in range(3))
        return _zeros_like(weight)

    def _one(self, weight, grad, state, scal, rescale_grad):
        lr, wd = scal
        kw = {"lr": lr, "epsilon": self.epsilon, "wd": wd,
              "rescale_grad": rescale_grad,
              "clip_gradient": self.clip_gradient}
        if self.centered:
            _ops.rmspropalex_update(weight, grad, *state, gamma1=self.gamma1,
                                    gamma2=self.gamma2, **kw)
        else:
            _ops.rmsprop_update(weight, grad, state, gamma1=self.gamma1,
                                **kw)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (``optimizer.py:321-336``): ``ftrl_update``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _one(self, weight, grad, state, scal, rescale_grad):
        lr, wd = scal
        _ops.ftrl_update(weight, grad, state[0], state[1], lr=lr,
                         lamda1=self.lamda1, beta=self.beta, wd=wd,
                         rescale_grad=rescale_grad,
                         clip_gradient=self.clip_gradient)


@register
class Adamax(Optimizer):
    """Adamax (``optimizer.py:339-359``): ``lr / (1 - beta1^t)`` folded
    into the rate."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _scalars(self, index):
        lr, wd = super()._scalars(index)
        return lr / (1.0 - self.beta1 ** self._index_update_count[index]), wd

    @torch.no_grad()
    def _one(self, weight, grad, state, scal, rescale_grad):
        lr, wd = scal
        g = self._clip(grad * rescale_grad + wd * weight)
        m, u = state
        m.mul_(self.beta1).add_((1 - self.beta1) * g)
        torch.maximum(u * self.beta2, torch.abs(g), out=u)
        weight.sub_(lr * m / (u + 1e-8))


@register
class Nadam(Optimizer):
    """Nadam (``optimizer.py:362-393``). Its momentum schedule is one
    product for the whole optimizer, advanced at every weight's update, as
    there; the step's values are scalars of their own: ``(lr, wd, 1 -
    schedule, 1 - next schedule, 1 - beta2^t, 1 - momentum_t,
    momentum_t+1)``."""

    n_scalars = 7

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon, self.schedule_decay = epsilon, schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _scalars(self, index):
        lr, wd = super()._scalars(index)
        t = self._index_update_count[index]
        mt = self.beta1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        mt1 = self.beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1) *
                                                 self.schedule_decay))
        self.m_schedule *= mt
        return (lr, wd, 1 - self.m_schedule, 1 - self.m_schedule * mt1,
                1 - self.beta2 ** t, 1 - mt, mt1)

    @torch.no_grad()
    def _one(self, weight, grad, state, scal, rescale_grad):
        lr, wd, c_sched, c_next, c2, one_mt, mt1 = scal
        g = self._clip(grad * rescale_grad + wd * weight)
        m, v = state
        m.mul_(self.beta1).add_((1 - self.beta1) * g)
        v.mul_(self.beta2).add_((1 - self.beta2) * g * g)
        m_bar = one_mt * (g / c_sched) + mt1 * (m / c_next)
        weight.sub_(lr * m_bar / (torch.sqrt(v / c2) + self.epsilon))


@register
class Signum(Optimizer):
    """signSGD with momentum (``optimizer.py:396-414``): ``signum_update``,
    or ``signsgd_update`` without momentum."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def _one(self, weight, grad, state, scal, rescale_grad):
        lr, wd = scal
        if state is not None:
            _ops.signum_update(weight, grad, state, lr, self.momentum, wd,
                               rescale_grad, self.clip_gradient, self.wd_lh)
        else:
            _ops.signsgd_update(weight, grad, lr, wd, rescale_grad,
                                self.clip_gradient)


def _normal(like, std, generator):
    """Gaussian noise of ``like``'s shape, dtype and device with standard
    deviation ``std``, drawn from ``generator`` (the global stream when
    None)."""
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=like.device) * std


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (``optimizer.py:417-430``):
    ``w += -lr / 2 * g + N(0, sqrt(lr))``. ``mxnet_tpu`` draws the noise
    from its JAX key, whose bits a torch generator cannot repeat; the port
    draws it from ``generator`` (a
    ``torch.Generator`` on the weights' device; the global stream when
    None)."""

    def __init__(self, generator=None, **kwargs):
        super().__init__(**kwargs)
        self.generator = generator

    @torch.no_grad()
    def _one(self, weight, grad, state, scal, rescale_grad):
        lr, wd = scal
        g = self._clip(grad * rescale_grad + wd * weight)
        noise = _normal(weight, _ops._sqrt(lr), self.generator)
        weight.copy_(weight - lr / 2 * g + noise)


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (``optimizer.py:433-458``)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.lamda = momentum, lamda

    def create_state(self, index, weight):
        return (_zeros_like(weight) if self.momentum != 0.0 else None,
                weight.detach().clone())

    @torch.no_grad()
    def _one(self, weight, grad, state, scal, rescale_grad):
        lr, wd = scal
        g = self._clip(grad * rescale_grad)
        mom, prev_w = state
        d = g + wd * weight + self.lamda * g * g * (weight - prev_w)
        if mom is not None:
            mom.mul_(self.momentum).sub_(lr * d)
            upd = mom
        else:
            upd = -lr * d
        prev_w.copy_(weight)
        weight.add_(upd)


@register
class FTML(Optimizer):
    """Follow the moving leader (``optimizer.py:461-484``): ``ftml_step``
    with ``(lr, wd, (1 - beta1^t) / lr, 1 - beta2^t)``."""

    n_scalars = 4

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return tuple(_zeros_like(weight) for _ in range(3))

    def _scalars(self, index):
        lr, wd = super()._scalars(index)
        t = self._index_update_count[index]
        return lr, wd, (1 - self.beta1 ** t) / lr, 1 - self.beta2 ** t

    def _one(self, weight, grad, state, scal, rescale_grad):
        _, wd, k, c2 = scal
        _ops.ftml_step(weight, grad, *state, k, c2, self.beta1, self.beta2,
                       self.epsilon, wd, rescale_grad,
                       -1.0 if self.clip_gradient is None
                       else self.clip_gradient)


@register
class LAMB(Optimizer):
    """LAMB (``optimizer.py:487-523``): Adam's direction scaled per weight
    by the trust ratio ``||w|| / ||u||``, as one ``multi_lamb_update``
    over the group (MXNet's aggregated LAMB); the bias corrections ``1 -
    beta1^t`` and ``1 - beta2^t`` are the third and fourth scalars."""

    n_scalars = 4

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _scalars(self, index):
        lr, wd = super()._scalars(index)
        t = self._index_update_count[index]
        return lr, wd, 1 - self.beta1 ** t, 1 - self.beta2 ** t

    def apply(self, weights, grads, states, scal, rescale_grad):
        lrs, wds = _lrs_wds(scal)
        _ops.multi_lamb_update(
            weights, grads, [s[0] for s in states], [s[1] for s in states],
            lrs, wds, self.beta1, self.beta2, self.epsilon, rescale_grad,
            self.clip_gradient,
            [s[2:] for s in scal] if self.bias_correction else None,
            self.lower_bound, self.upper_bound)


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling (``optimizer.py:526-558``): the
    rate times ``eta * ||w|| / (||g|| + wd * ||w|| + eps)`` where both
    norms are positive, computed on the device (``mxnet_tpu`` reads the
    norms to the host)."""

    def __init__(self, momentum=0.0, eta=0.001, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.eta, self.epsilon = momentum, eta, epsilon

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    @torch.no_grad()
    def _one(self, weight, grad, state, scal, rescale_grad):
        lr, wd = scal
        g = self._clip(grad * rescale_grad)
        w_norm = torch.linalg.vector_norm(weight)
        g_norm = torch.linalg.vector_norm(g)
        ratio = self.eta * w_norm / (g_norm + wd * w_norm + self.epsilon)
        lr = lr * torch.where((w_norm > 0) & (g_norm > 0), ratio,
                              torch.ones_like(ratio))
        if state is not None:
            state.mul_(self.momentum).sub_(lr * (g + wd * weight))
            weight.add_(state)
        else:
            weight.sub_(lr * (g + wd * weight))


@register
class LBSGD(SGD):
    """Large-batch SGD (``optimizer.py:561-570``): SGD; the warm-up
    parameters are accepted, as there."""

    def __init__(self, warmup_strategy="linear", warmup_epochs=5,
                 batch_scale=1, updates_per_epoch=32, begin_epoch=0,
                 num_epochs=60, **kwargs):
        super().__init__(**kwargs)
        self.warmup_strategy = warmup_strategy


@register
class Test(Optimizer):
    """The reference's debugging optimizer (``optimizer.py:573-584``):
    ``w += g * rescale_grad``, the state a copy of ``w``; it counts no
    update, as there."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def _scalars(self, index):
        return self._get_lr(index), self._get_wd(index)

    @torch.no_grad()
    def _one(self, weight, grad, state, scal, rescale_grad):
        weight.add_(grad * rescale_grad)
        state.copy_(weight)


# ---------------------------------------------------- the states' bytes
# mxnet_tpu pickles numpy arrays; a bfloat16 state is an ml_dtypes array,
# which pickles as numpy's _reconstruct of a dtype built from the class
# ml_dtypes.bfloat16. The port neither needs nor imports ml_dtypes: it
# writes a bfloat16 state as numpy.ndarray.view(<uint16 bits>, "bfloat16")
# (a reader that has ml_dtypes, as mxnet_tpu always does, gets the
# ml_dtypes array), and its reader maps ml_dtypes' class and that view to
# the raw bits, which become a torch.bfloat16 tensor.

class _Bf16Bits:
    """A bfloat16 array as its uint16 bit patterns."""

    def __init__(self, bits):
        self.bits = bits


class _Bf16Dtype:
    def __setstate__(self, state):
        pass


class _ArrayStub:
    """What the reader's ``_reconstruct`` returns: pickle's BUILD hands it
    the array's state, which becomes a numpy array or, for a bfloat16
    dtype, its bits."""

    value = None

    def __setstate__(self, state):
        _, shape, dtype, _, raw = state
        if isinstance(dtype, _Bf16Dtype):
            self.value = _Bf16Bits(_np.frombuffer(raw, "<u2").reshape(shape))
            return
        arr = _np.empty(0, _np.uint8)
        arr.__setstate__(state)
        self.value = arr


def _reconstruct(cls, shape, typecode):
    return _ArrayStub()


def _dtype(obj, align=False, copy=False):
    if obj is _BF16:
        return _Bf16Dtype()
    return _np.dtype(obj, align, copy)


def _view(arr, dtype):
    arr = arr.value if isinstance(arr, _ArrayStub) else arr
    if dtype == "bfloat16":
        return _Bf16Bits(_np.asarray(arr, "<u2"))
    return arr.view(dtype)


def _getattr(obj, name):
    if obj is _np.ndarray and name == "view":
        return _view
    return getattr(obj, name)


class _BF16:
    """Stands in for ``ml_dtypes.bfloat16`` while reading."""


class _StatesUnpickler(pickle.Unpickler):
    _MAP = {("ml_dtypes", "bfloat16"): _BF16,
            ("numpy", "dtype"): _dtype,
            ("numpy.core.multiarray", "_reconstruct"): _reconstruct,
            ("numpy._core.multiarray", "_reconstruct"): _reconstruct,
            ("builtins", "getattr"): _getattr}

    def find_class(self, module, name):
        hit = self._MAP.get((module, name))
        return hit if hit is not None else super().find_class(module, name)


class _StatesPickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, _Bf16Bits):
            return _np.ndarray.view, (obj.bits, "bfloat16")
        return NotImplemented


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return _Bf16Bits(x.view(torch.int16).numpy().view(_np.uint16))
        return x.numpy().copy()
    if isinstance(x, tuple):
        return tuple(_to_numpy(y) for y in x)
    return x


def _to_tensor(x):
    if isinstance(x, _ArrayStub):
        x = x.value
    if isinstance(x, _Bf16Bits):
        return torch.from_numpy(_np.array(x.bits, _np.uint16).view(
            _np.int16)).view(torch.bfloat16)
    if isinstance(x, _np.ndarray):
        return torch.from_numpy(_np.array(x))
    if isinstance(x, (tuple, list)):
        return tuple(_to_tensor(y) for y in x)
    return x


def _dumps_states(obj):
    buf = io.BytesIO()
    _StatesPickler(buf, protocol=pickle.DEFAULT_PROTOCOL).dump(obj)
    return buf.getvalue()


def _loads_states(data):
    return _StatesUnpickler(io.BytesIO(data)).load()


def _on(state, device):
    """``state`` (a tensor, a tuple of states or None) on ``device``."""
    if isinstance(state, torch.Tensor):
        return state if state.device == device else state.to(device)
    if isinstance(state, tuple):
        return tuple(_on(s, device) for s in state)
    return state


class Updater:
    """Applies an optimizer per index, creating each index's state at its
    first update (``optimizer.py:587-686``)."""

    # the reserved key of the per-index update counts, so that a resumed
    # run takes the same bias corrections as the uninterrupted one
    _COUNTS_KEY = "__update_counts__"

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self._loaded = set()     # indices whose states came from bytes

    def state(self, index, weight):
        """``index``'s state, created at its first use; a state read by
        :meth:`set_states` moves to ``weight``'s device at its first use."""
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
        elif index in self._loaded:
            self.states[index] = _on(self.states[index], weight.device)
            self._loaded.discard(index)
        return self.states[index]

    def __call__(self, index, grad, weight):
        """Update ``weight`` in place from ``grad`` (tensors, or NDArrays,
        whose tensors are used)."""
        grad, weight = getattr(grad, "_data", grad), \
            getattr(weight, "_data", weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.state(index, weight))

    def get_states(self, dump_optimizer=False):
        """The states and update counts as ``mxnet_tpu``'s bytes."""
        out = {k: _to_numpy(v) for k, v in self.states.items()}
        counts = self.optimizer._index_update_count
        if counts:
            out[self._COUNTS_KEY] = dict(counts)
        return _dumps_states(out)

    def set_states(self, states):
        """Read :meth:`get_states`' bytes (or ``mxnet_tpu``'s): the states
        as CPU tensors until their first use, and the update counts."""
        data = _loads_states(states)
        counts = data.pop(self._COUNTS_KEY, None)
        self.states = {k: _to_tensor(v) for k, v in data.items()}
        self._loaded = set(self.states)
        if counts is not None:
            self.optimizer._index_update_count = dict(counts)
            self.optimizer.num_update = max(
                [self.optimizer.begin_num_update, *counts.values()])


def get_updater(optimizer):
    """An :class:`Updater` for ``optimizer`` (``optimizer.py:686``)."""
    return Updater(optimizer)

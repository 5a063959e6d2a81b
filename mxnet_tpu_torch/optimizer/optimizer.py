"""Optimizers (subset of ``mxnet_tpu/optimizer/optimizer.py``; parity:
python/mxnet/optimizer/optimizer.py).

An :class:`Optimizer` holds the hyper-parameters and the per-index update
counts; its ``update`` calls a fused update op of
:mod:`mxnet_tpu_torch.ops.optimizer_ops`, which writes the weight and the
state tensors in place. States are zeros in the weight's dtype on its
device. ``multi_precision`` master weights cover float16 only, as in the
reference, so a bf16 net trains with bf16 weights and states. Ported:
``SGD`` (with momentum) and ``Adam``; the other optimizers wait in ROADMAP
Queue 1. ``lr_scheduler`` takes a scheduler of
:mod:`mxnet_tpu_torch.lr_scheduler` (or any callable of the update count
with a ``base_lr``), which gives the rate at every update.

An update is two parts: :meth:`Optimizer._scalars` advances the update
counts and gives the index's ``lr`` and ``wd`` as Python floats (the rate
with its schedule and, for Adam, its bias correction), and
:meth:`Optimizer.apply` runs the multi-tensor op over a group of weights
with those scalars, given as floats or as 0-d device tensors ("slots").
``gluon.Trainer`` runs its whole sweep as one op; a captured step
(:mod:`mxnet_tpu_torch.capture`) runs the first part on the host every
step and writes its values into the slots its graph reads.

Weight decay: ``wd`` times the parameter's ``wd_mult``. Through
``gluon.Trainer`` every parameter's ``wd_mult`` comes from its Parameter
(1.0 unless set), biases and BatchNorm's gamma and beta included, as in
``mxnet_tpu``; the zero default for names ending in ``_bias``, ``_gamma``
or ``_beta`` applies where the optimizer is built with ``param_idx2name``
and no ``param_dict``.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..ops import optimizer_ops as _ops

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create",
           "register"]

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
        # gluon.Trainer always updates every weight in one multi-tensor op
        self.aggregate_num = int(aggregate_num)

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and weight.dtype == torch.float16:
            w32 = weight.detach().float()
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    def _scalars(self, index):
        """Advance ``index``'s update count; its ``(lr, wd)`` for this
        update, as Python floats."""
        self._update_count(index)
        return self._get_lr(index), self._get_wd(index)

    def apply(self, weights, grads, states, lrs, wds, rescale_grad):
        """One multi-tensor update of ``weights`` in place: ``lrs`` and
        ``wds`` hold one scalar per weight and ``rescale_grad`` one for
        all, each a float or a 0-d float32 tensor on the weights' device."""
        raise NotImplementedError

    def update(self, index, weight, grad, state):
        lr, wd = self._scalars(index)
        self.apply([weight], [grad], [state], [lr], [wd], self.rescale_grad)

    def _is_mp(self, weight):
        return self.multi_precision and weight.dtype == torch.float16

    def update_multi_precision(self, index, weight, grad, state):
        lr, wd = self._scalars(index)
        self.update_group([weight], [grad], [state], [lr], [wd],
                          self.rescale_grad)

    def update_group(self, weights, grads, states, lrs, wds, rescale_grad):
        """:meth:`apply` over a group, fp16 weights with ``multi_precision``
        updated through their float32 masters one at a time."""
        plain = []
        for k, (w, g, s) in enumerate(zip(weights, grads, states)):
            if not self._is_mp(w):
                plain.append(k)
                continue
            inner_state, w32 = s
            self.apply([w32], [g.float()], [inner_state], [lrs[k]],
                       [wds[k]], rescale_grad)
            with torch.no_grad():
                w.copy_(w32)
        if plain:
            self.apply([weights[k] for k in plain], [grads[k] for k in plain],
                       [states[k] for k in plain], [lrs[k] for k in plain],
                       [wds[k] for k in plain], rescale_grad)

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


def _zeros_like(weight):
    return torch.zeros_like(weight, memory_format=torch.contiguous_format)


@register
class SGD(Optimizer):
    """SGD with optional momentum (``optimizer.py:147-183``): the fused
    ``multi_sgd_update`` / ``multi_sgd_mom_update``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def apply(self, weights, grads, states, lrs, wds, rescale_grad):
        if self.momentum != 0.0:
            _ops.multi_sgd_mom_update(weights, grads, states, lrs, wds,
                                      self.momentum, rescale_grad,
                                      self.clip_gradient)
        else:
            _ops.multi_sgd_update(weights, grads, lrs, wds, rescale_grad,
                                  self.clip_gradient)


@register
class Adam(Optimizer):
    """Adam (``optimizer.py:208-227``): the bias correction is folded into
    the learning rate, ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)``, then
    the fused ``multi_adam_update``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _scalars(self, index):
        lr, wd = super()._scalars(index)
        t = self._index_update_count[index]
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        return lr, wd

    def apply(self, weights, grads, states, lrs, wds, rescale_grad):
        _ops.multi_adam_update(weights, grads, [s[0] for s in states],
                               [s[1] for s in states], lrs, wds, self.beta1,
                               self.beta2, self.epsilon, rescale_grad,
                               self.clip_gradient)


class Updater:
    """Applies an optimizer per index, creating each index's state at its
    first update (``optimizer.py:587``)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def state(self, index, weight):
        """``index``'s state, created at its first use."""
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.state(index, weight))


def get_updater(optimizer):
    """An :class:`Updater` for ``optimizer`` (``optimizer.py:686``)."""
    return Updater(optimizer)

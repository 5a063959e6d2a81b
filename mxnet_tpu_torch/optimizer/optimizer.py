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
                 **kwargs):
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

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and weight.dtype == torch.float16:
            w32 = weight.detach().float()
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and weight.dtype == torch.float16:
            inner_state, w32 = state
            self.update(index, w32, grad.float(), inner_state)
            with torch.no_grad():
                weight.copy_(w32)
        else:
            self.update(index, weight, grad, state)

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

    def _common_kwargs(self, index):
        kw = {"lr": self._get_lr(index), "wd": self._get_wd(index),
              "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw


def _zeros_like(weight):
    return torch.zeros_like(weight, memory_format=torch.contiguous_format)


@register
class SGD(Optimizer):
    """SGD with optional momentum (``optimizer.py:147-183``): the fused
    ``sgd_update`` / ``sgd_mom_update``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        if state is not None:
            _ops.sgd_mom_update(weight, grad, state, momentum=self.momentum,
                                **kw)
        else:
            _ops.sgd_update(weight, grad, **kw)


@register
class Adam(Optimizer):
    """Adam (``optimizer.py:208-227``): the bias correction is folded into
    the learning rate, ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)``, then
    the fused ``adam_update``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        kw = self._common_kwargs(index)
        kw["lr"] *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = state
        _ops.adam_update(weight, grad, mean, var, beta1=self.beta1,
                         beta2=self.beta2, epsilon=self.epsilon, **kw)


class Updater:
    """Applies an optimizer per index, creating each index's state at its
    first update (``optimizer.py:587``)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])


def get_updater(optimizer):
    """An :class:`Updater` for ``optimizer`` (``optimizer.py:686``)."""
    return Updater(optimizer)

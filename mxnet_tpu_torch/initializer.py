"""Weight initializers (parity: python/mxnet/initializer.py).

Counterpart of ``mxnet_tpu/initializer.py`` (subset: Zero, One, Uniform,
Xavier). An initializer fills a tensor in place and dispatches on the
parameter's name as MXNet does: ``*_weight`` draws from the initializer's
distribution, ``*_bias``/``*_beta`` are zeros, ``*_gamma`` ones, running
means zeros and running variances ones (``mxnet_tpu/initializer.py:78-81``),
a fused RNN's flat ``*_parameters`` U(-0.07, 0.07), and any other name (an
RNN's learned ``*_state``) as a weight. Random
draws come from the ``torch.Generator`` the caller passes, so a seed fixes
the weights. The generator does not reproduce ``mxnet_tpu``'s random
bits: tests carry weights across with ``Block.load_numpy_params``.
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError

__all__ = ["Initializer", "Zero", "One", "Uniform", "Xavier", "create"]


class Initializer:
    """Base class: ``init(name, tensor, generator)`` fills ``tensor``."""

    def __call__(self, name, arr, generator=None):
        with torch.no_grad():
            if name.endswith("parameters"):
                self._init_rnn(name, arr, generator)
            elif name.endswith("weight"):
                self._init_weight(name, arr, generator)
            elif name.endswith("bias") or name.endswith("beta"):
                arr.zero_()
            elif name.endswith("gamma"):
                arr.fill_(1.0)
            elif name.endswith("moving_mean") or name.endswith("running_mean"):
                arr.zero_()
            elif name.endswith("moving_var") or name.endswith("running_var"):
                arr.fill_(1.0)
            else:
                self._init_weight(name, arr, generator)

    def _init_rnn(self, name, arr, generator):
        """A fused RNN's flat ``*_parameters`` vector: U(-0.07, 0.07),
        whatever the initializer (``mxnet_tpu/initializer.py:91-98``)."""
        arr.uniform_(-0.07, 0.07, generator=generator)

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError


class Zero(Initializer):
    def _init_weight(self, _, arr, generator):
        arr.zero_()


class One(Initializer):
    def _init_weight(self, _, arr, generator):
        arr.fill_(1.0)


class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, _, arr, generator):
        arr.uniform_(-self.scale, self.scale, generator=generator)


class Xavier(Initializer):
    """Glorot init: scale sqrt(magnitude / fan) with fan by ``factor_type``."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr, generator):
        shape = arr.shape
        if len(shape) < 2:
            raise MXNetError(f"Xavier init needs >=2d weight, got {name} "
                             f"with shape {tuple(shape)}")
        hw_scale = math.prod(shape[2:]) if len(shape) > 2 else 1
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0,
                  "in": fan_in, "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr.uniform_(-scale, scale, generator=generator)
        else:
            arr.normal_(0.0, scale, generator=generator)


_NAMED = {"zeros": Zero, "ones": One}


def create(init):
    """An Initializer, or 'zeros' / 'ones', -> Initializer."""
    if init is None or isinstance(init, Initializer):
        return init
    try:
        return _NAMED[init]()
    except (KeyError, TypeError):
        raise MXNetError(f"cannot create initializer from {init!r}") from None

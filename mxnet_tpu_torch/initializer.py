"""Weight initializers (parity: python/mxnet/initializer.py).

Counterpart of ``mxnet_tpu/initializer.py:21-290``: the same classes,
registry names (``create("normal")``, ``"zeros"``, ``"xavier"``, ...) and
dispatch on the parameter's name as MXNet does: ``*_weight`` draws from the
initializer's distribution, ``*_bias`` / ``*_beta`` are zeros, ``*_gamma``
ones, ``*_min`` zeros and ``*_max`` ones, running means zeros and running
variances ones, a fused RNN's flat ``*_parameters`` U(-0.07, 0.07), and any
other name (an RNN's learned ``*_state``) as a weight. An initializer fills
a tensor in place: ``init(name, tensor, generator)``, where ``name`` may be
an :class:`InitDesc`.

Random draws come from the ``torch.Generator`` the caller passes (the one
``Block.initialize(generator=)`` threads through), so a seed fixes the
weights. They follow ``mxnet_tpu``'s distributions, not its random bits
(ROADMAP Queue 3, deliberate differences): tests carry weights across with
``Block.load_numpy_params``. ``Orthogonal`` draws its matrix from the
generator too, where ``mxnet_tpu`` draws from numpy's global state.
"""
from __future__ import annotations

import json
import math
import re

import numpy as _np
import torch

from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "Mixed", "Load", "register", "create"]

_REGISTRY = {}


def register(klass):
    """Register ``klass`` under its name and its lower-cased name
    (``mxnet_tpu/initializer.py:23-26``)."""
    _REGISTRY[klass.__name__] = klass
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(init, **kwargs):
    """An Initializer (returned as it is), a registered name
    (``"normal"``, ``"zeros"``, ``"xavier"``, ...) made with ``kwargs``,
    or None."""
    if init is None or isinstance(init, (Initializer, Load)):
        return init
    if isinstance(init, str):
        try:
            klass = _REGISTRY[init]
        except KeyError:
            raise MXNetError(f"cannot create initializer from {init!r}: "
                             f"not one of {sorted(_REGISTRY)}") from None
        return klass(**kwargs)
    raise MXNetError(f"cannot create initializer from {init!r}")


class InitDesc(str):
    """A parameter's name with its ``attrs`` hint and a ``global_init``
    (``mxnet_tpu/initializer.py:38-45``)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base class: ``init(name, tensor, generator)`` fills ``tensor``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """``'["name", {kwargs}]'``, as MXNet serializes an initializer."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, name, arr, generator=None):
        if not isinstance(name, str):
            raise TypeError("call signature: (name or InitDesc, tensor, "
                            "generator=None)")
        with torch.no_grad():
            self._dispatch(name, arr, generator)

    def _dispatch(self, name, arr, generator):
        if name.endswith("parameters"):     # a fused RNN's flat vector
            self._init_rnn(name, arr, generator)
        elif name.endswith("weight"):
            self._init_weight(name, arr, generator)
        elif name.endswith("bias"):
            self._init_bias(name, arr, generator)
        elif name.endswith("gamma"):
            arr.fill_(1.0)
        elif name.endswith("beta") or name.endswith("min"):
            arr.zero_()
        elif name.endswith("max"):
            arr.fill_(1.0)
        elif name.endswith("moving_mean") or name.endswith("running_mean"):
            arr.zero_()
        elif name.endswith("moving_var") or name.endswith("running_var"):
            arr.fill_(1.0)
        elif name.endswith("moving_inv_var") or name.endswith("moving_avg"):
            arr.zero_()
        else:
            self._init_default(name, arr, generator)

    def _init_bias(self, name, arr, generator):
        arr.zero_()

    def _init_rnn(self, name, arr, generator):
        """A fused RNN's flat ``*_parameters`` vector: U(-0.07, 0.07),
        whatever the initializer (``mxnet_tpu/initializer.py:91-98``)."""
        arr.uniform_(-0.07, 0.07, generator=generator)

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError

    def _init_default(self, name, arr, generator):
        self._init_weight(name, arr, generator)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr, generator):
        arr.zero_()


@register
class One(Initializer):
    def _init_weight(self, _, arr, generator):
        arr.fill_(1.0)


_REGISTRY["zeros"] = Zero
_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    """Every weight ``value`` (a number, or an array broadcast to the
    weight's shape)."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr, generator):
        value = self.value
        if hasattr(value, "asnumpy"):        # an mx.nd array
            value = value.asnumpy()
        if isinstance(value, (int, float)):
            arr.fill_(float(value))
        else:
            arr.copy_(torch.as_tensor(_np.asarray(value), dtype=arr.dtype))


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr, generator):
        arr.uniform_(-self.scale, self.scale, generator=generator)


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr, generator):
        arr.normal_(0.0, self.sigma, generator=generator)


@register
class Orthogonal(Initializer):
    """``scale`` times the orthonormal factor of a uniform or normal
    (out, prod(rest)) matrix (``mxnet_tpu/initializer.py:166-184``)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr, generator):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        tmp = torch.empty((nout, nin), dtype=torch.float64,
                          device=arr.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(0.0, 1.0, generator=generator)
        u, _, v = torch.linalg.svd(tmp.cpu(), full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        arr.copy_((self.scale * q).reshape(arr.shape))


@register
class Xavier(Initializer):
    """Glorot init: scale sqrt(magnitude / fan) with fan by ``factor_type``
    ("avg", "in", "out"), uniform or ``"gaussian"``."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
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


@register
class MSRAPrelu(Xavier):
    """He init for PReLU of ``slope``: gaussian Xavier with magnitude
    2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel on the last two axes
    (``mxnet_tpu/initializer.py:222-233``)."""

    def _init_weight(self, _, arr, generator):
        shape = arr.shape
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = torch.arange(shape[3], dtype=torch.float64)
        y = torch.arange(shape[2], dtype=torch.float64)
        kern = (1 - (y / f - c).abs())[:, None] * \
            (1 - (x / f - c).abs())[None, :]
        arr.copy_(kern.to(torch.float32).expand(shape))


@register
class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter (gates i, f, g, o) at
    ``forget_bias``; whatever the parameter's name."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr, generator):
        arr.zero_()
        num_hidden = arr.shape[0] // 4
        arr[num_hidden:2 * num_hidden] = self.forget_bias

    _init_default = _init_weight
    _init_bias = _init_weight


@register
class Mixed(Initializer):
    """The first initializer whose pattern matches the name (``re.match``);
    a name that matches none raises."""

    def __init__(self, patterns, initializers):
        super().__init__()
        if len(patterns) != len(initializers):
            raise ValueError("Mixed: patterns and initializers differ in "
                             "length")
        self.map = list(zip([re.compile(p) for p in patterns],
                            [create(i) for i in initializers]))

    def __call__(self, name, arr, generator=None):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr, generator)
                return
        raise MXNetError(f"parameter {name} did not match any pattern")


class Load:
    """Values from a dict of arrays (or an ``mx.nd.save`` file), names
    stripped of ``arg:`` / ``aux:``; a name not there goes to
    ``default_init``, else raises."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from . import ndarray as nd

            param = nd.load(param)
        self.param = {k.replace("arg:", "").replace("aux:", ""): v
                      for k, v in param.items()}
        self.default_init = create(default_init)
        self.verbose = verbose

    def __call__(self, name, arr, generator=None):
        if name in self.param:
            value = self.param[name]
            value = value.asnumpy() if hasattr(value, "asnumpy") else value
            value = torch.as_tensor(_np.asarray(value)) \
                if not isinstance(value, torch.Tensor) else value
            if tuple(value.shape) != tuple(arr.shape):
                raise MXNetError(f"Load: {name} has shape "
                                 f"{tuple(value.shape)}, the parameter "
                                 f"{tuple(arr.shape)}")
            with torch.no_grad():
                arr.copy_(value)
        elif self.default_init is not None:
            self.default_init(name, arr, generator)
        else:
            raise MXNetError(f"cannot init {name}: not found and no default")

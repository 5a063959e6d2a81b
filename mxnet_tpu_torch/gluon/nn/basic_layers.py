"""Gluon basic layers (port of ``mxnet_tpu/gluon/nn/basic_layers.py``;
parity: python/mxnet/gluon/nn/basic_layers.py, activations.py).

Every layer with parameters accepts an unknown (0) input width and infers
it at the first forward (``_infer_shapes``), as MXNet's deferred
initialization does.
"""
from __future__ import annotations

import torch

from ..block import Block, HybridBlock, F_TENSOR
from ...base import MXNetError, torch_dtype
from ... import initializer
from ...ops import math as _math
from ...ops import nn as _nn

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "InstanceNorm", "LayerNorm", "GroupNorm", "Embedding", "Flatten",
           "Lambda", "HybridLambda", "Activation", "LeakyReLU", "PReLU",
           "ELU", "SELU", "Swish", "GELU"]


class Sequential(Block):
    """Stacks Blocks sequentially (gluon/nn/basic_layers.py:30)."""

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)


class HybridSequential(HybridBlock):
    """Stacks blocks sequentially (gluon/nn/basic_layers.py:98)."""

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)


class Dense(HybridBlock):
    """``act(x @ weight.T + bias)`` with weight (units, in_units)
    (gluon/nn/basic_layers.py:144). Without ``in_units`` the weight waits
    for the first forward, which reads the input's width."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        self._units = units
        self._in_units = in_units
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=bias_initializer,
                    dtype=dtype)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def _infer_shapes(self, x, *args):
        width = 1
        for s in (x.shape[1:] if self._flatten else x.shape[-1:]):
            width *= s
        return {"weight": (self._units, width)}

    def hybrid_forward(self, F, x, weight, bias=None):
        """``mxnet_tpu/gluon/nn/basic_layers.py:134``."""
        out = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten)
        return self.act(out) if self.act is not None else out


class Dropout(HybridBlock):
    """Dropout (gluon/nn/basic_layers.py:235): in training each element
    (each slice along ``axes``) is kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)``; in predict mode, or at rate 0, the input
    passes unchanged. The mask is drawn from ``mx.random``'s generator of
    the input's device, which a captured step registers with its graph, so
    a replay draws what the eager step draws."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate == 0:
            return x
        return F.Dropout(x, p=self._rate, axes=self._axes)

    def __repr__(self):
        return f"{type(self).__name__}(p = {self._rate}, axes={self._axes})"


def _channel_shapes(names, n):
    return {name: (n,) for name in names}


class BatchNorm(HybridBlock):
    """Batch normalization (gluon/nn/basic_layers.py:282;
    ``mxnet_tpu/gluon/nn/basic_layers.py:166-211``). Without
    ``in_channels`` the four parameters take the input's width on ``axis``
    at the first forward.

    Inside ``autograd.record()`` / ``train_mode()`` it normalises with the
    batch's statistics and writes the updated running statistics back into
    ``running_mean``/``running_var`` in place; otherwise it uses them.
    ``cast('float16')`` keeps the parameters in float32, as MXNet does."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self.in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, differentiable=False)

    def _infer_shapes(self, x, *args):
        return _channel_shapes(("gamma", "beta", "running_mean",
                                "running_var"), x.shape[self._axis])

    def cast(self, dtype):
        if torch_dtype(dtype) == torch.float16:
            dtype = "float32"
        return super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           name="fwd", **self._kwargs)


class InstanceNorm(HybridBlock):
    """Instance normalization (gluon/nn/basic_layers.py:457): statistics
    over each sample's spatial positions, per channel on ``axis``. With
    ``scale=False`` (the default) or ``center=False`` the parameter stays,
    ones or zeros with ``grad_req="null"``, as in ``mxnet_tpu``."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer)

    def _infer_shapes(self, x, *args):
        return _channel_shapes(("gamma", "beta"), x.shape[self._axis])

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, name="fwd",
                                  eps=self._epsilon)
        x = x.swapaxes(1, self._axis)
        return F.InstanceNorm(x, gamma, beta, name="fwd",
                              eps=self._epsilon).swapaxes(1, self._axis)


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis`` (gluon/nn/basic_layers.py:546).
    Without ``in_channels`` the parameters take the input's width on
    ``axis``. With ``center=False`` / ``scale=False`` the parameter stays,
    zeros or ones with ``grad_req="null"``
    (``mxnet_tpu/gluon/nn/basic_layers.py:252-330``)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None):
        super().__init__(prefix=prefix)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer)

    def _infer_shapes(self, x, *args):
        return _channel_shapes(("gamma", "beta"), x.shape[self._axis])

    def forward(self, x):
        if self._pending_init:
            self._finish_deferred_init(x)
        return _nn.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                              eps=self._epsilon)


class GroupNorm(HybridBlock):
    """Group normalization (gluon/nn/basic_layers.py:625): statistics over
    each group of channels; ``gamma`` and ``beta`` are one a group, as
    ``mxnet_tpu`` has them."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 prefix=None):
        super().__init__(prefix=prefix)
        self._num_groups = num_groups
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(num_groups,), init=gamma_initializer)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(num_groups,), init=beta_initializer)

    def _infer_shapes(self, x, *args):
        return _channel_shapes(("gamma", "beta"), self._num_groups)

    def hybrid_forward(self, F, data, gamma, beta):
        return F.GroupNorm(data, gamma, beta, num_groups=self._num_groups,
                           eps=self._epsilon)


class Embedding(HybridBlock):
    """Maps integer ids to rows of a (input_dim, output_dim) table
    (gluon/nn/basic_layers.py:379); out-of-range ids clip. The table's
    shape cannot be read off the ids: both widths must be given."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype)

    def _infer_shapes(self, x, *args):
        raise MXNetError(f"Embedding '{self.name}': input_dim and "
                         "output_dim must be given (the ids do not tell "
                         f"them), got {self._reg_params['weight'].shape}")

    def forward(self, x):
        if self._pending_init:
            self._finish_deferred_init(x)
        return _math.embedding(x, self.weight)


class Flatten(HybridBlock):
    """Flattens the input to (batch, -1) (gluon/nn/basic_layers.py:435)."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class Lambda(Block):
    """A function of tensors, or the name of an ``mx.nd`` op, as a Block
    (gluon/nn/basic_layers.py:701)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd

            if not hasattr(nd, function):
                raise ValueError(f"Function name {function} is not found in "
                                 "ndarray.")
            # the Block sees tensors (NDArrays are unboxed around it): the
            # registered op of that name, as mx.nd's function calls it
            self._func_impl = getattr(F_TENSOR, function)
            self._func_name = function
        elif callable(function):
            self._func_impl = function
            self._func_name = function.__name__
        else:
            raise ValueError("Unrecognized function in lambda: "
                             f"{function} of type {type(function)}")

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return f"{type(self).__name__}({self._func_name})"


class HybridLambda(HybridBlock):
    """``function(F, x, *args)``, or the registered op of that name, as a
    HybridBlock (gluon/nn/basic_layers.py:746)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ...ops import registry

            try:
                registry.get_op(function)
            except MXNetError:
                raise ValueError(f"Function name {function} is not found in "
                                 "ndarray/symbol.") from None
            self._func = lambda F, *args: getattr(F, function)(*args)
            self._func_name = function
        elif callable(function):
            self._func = function
            self._func_name = function.__name__
        else:
            raise ValueError("Unrecognized function in lambda: "
                             f"{function} of type {type(function)}")

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return f"{type(self).__name__}({self._func_name})"


class Activation(HybridBlock):
    """Applies an activation function; ``"gelu"`` is the tanh form."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type, name="fwd")


class LeakyReLU(HybridBlock):
    """Leaky ReLU (gluon/nn/activations.py:77)."""

    def __init__(self, alpha, **kwargs):
        if alpha < 0:
            raise ValueError("Slope coefficient for LeakyReLU must be no "
                             "less than 0.")
        super().__init__(**kwargs)
        self._alpha = alpha

    def forward(self, x):
        return _nn.leaky_relu(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """Parametric leaky ReLU, a learned slope a channel (or one for all
    with ``in_channels=1``, the default) (gluon/nn/activations.py:114).
    ``in_channels=0`` takes the input's channels at the first forward."""

    def __init__(self, alpha_initializer=initializer.Constant(0.25),
                 in_channels=1, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(in_channels,),
                                         init=alpha_initializer)

    def _infer_shapes(self, x, *args):
        return {"alpha": (x.shape[1],)}

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu", name="fwd")


class ELU(HybridBlock):
    """Exponential linear unit (gluon/nn/activations.py:153)."""

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled exponential linear unit (gluon/nn/activations.py:184)."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu", name="fwd")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)`` (gluon/nn/activations.py:210)."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class GELU(HybridBlock):
    """GELU through LeakyReLU(act_type="gelu"): the exact erf form
    (gluon/nn/activations.py:234)."""

    def forward(self, x):
        return _nn.leaky_relu(x, act_type="gelu")

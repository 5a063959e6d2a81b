"""Gluon basic layers (subset of ``mxnet_tpu/gluon/nn/basic_layers.py``;
parity: python/mxnet/gluon/nn/basic_layers.py)."""
from __future__ import annotations

import torch

from ..block import Block, HybridBlock
from ...base import torch_dtype
from ...ops import math as _math
from ...ops import nn as _nn

__all__ = ["Sequential", "HybridSequential", "Dense", "BatchNorm", "LayerNorm",
           "Embedding", "Flatten", "Activation", "LeakyReLU", "GELU"]


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


class BatchNorm(HybridBlock):
    """Batch normalization (gluon/nn/basic_layers.py:282;
    ``mxnet_tpu/gluon/nn/basic_layers.py:166-211``). ``in_channels`` is
    required.

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
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
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

    def cast(self, dtype):
        if torch_dtype(dtype) == torch.float16:
            dtype = "float32"
        return super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           name="fwd", **self._kwargs)


class LayerNorm(HybridBlock):
    """Layer normalization over the last axis (gluon/nn/basic_layers.py:546).
    ``in_channels`` is required."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None):
        super().__init__(prefix=prefix)
        if not (center and scale):
            raise NotImplementedError("LayerNorm: center=False / "
                                      "scale=False are not ported yet")
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(in_channels,),
                                         init=gamma_initializer)
            self.beta = self.params.get("beta", shape=(in_channels,),
                                        init=beta_initializer)

    def forward(self, x):
        return _nn.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                              eps=self._epsilon)


class Embedding(HybridBlock):
    """Maps integer ids to rows of a (input_dim, output_dim) table
    (gluon/nn/basic_layers.py:379); out-of-range ids clip."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype)

    def forward(self, x):
        return _math.embedding(x, self.weight)


class Flatten(HybridBlock):
    """Flattens the input to (batch, -1) (gluon/nn/basic_layers.py:435)."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)


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


class GELU(HybridBlock):
    """GELU through LeakyReLU(act_type="gelu"): the exact erf form
    (gluon/nn/activations.py:234)."""

    def forward(self, x):
        return _nn.leaky_relu(x, act_type="gelu")

"""Gluon convolution and pooling layers (subset of
``mxnet_tpu/gluon/nn/conv_layers.py``; parity:
python/mxnet/gluon/nn/conv_layers.py).

``layout`` is NCHW (OIHW weights) or NHWC (OHWI weights, ``mxnet_tpu``'s
channels-last parameter shape, so carried weights load unchanged).
Without ``in_channels`` the weight waits for the first forward, which
reads the input's channels (deferred initialization).
"""
from __future__ import annotations

import numpy as _np

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalMaxPool2D",
           "GlobalAvgPool2D"]


def _tuple(v, n):
    if isinstance(v, (int, _np.integer)):
        return (int(v),) * n
    # asymmetric (lo, hi) padding pairs pass through untouched
    return tuple(tuple(int(y) for y in x) if isinstance(x, (tuple, list))
                 else int(x) for x in v)


class _Conv(HybridBlock):
    """Base for conv layers (reference gluon/nn/conv_layers.py:33)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None):
        super().__init__(prefix=prefix)
        ndim = len(kernel_size)
        self._kwargs = {
            "kernel": kernel_size, "stride": _tuple(strides, ndim),
            "dilate": _tuple(dilation, ndim), "pad": _tuple(padding, ndim),
            "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        with self.name_scope():
            if layout and layout[1] != "C":  # channels-last: OHWI weights
                wshape = (channels,) + tuple(kernel_size) + \
                    (in_channels // groups,)
            else:
                wshape = (channels, in_channels // groups) + \
                    tuple(kernel_size)
            self.weight = self.params.get("weight", shape=wshape,
                                          init=weight_initializer)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def _alias(self):
        return "conv"

    def _infer_shapes(self, x, *args):
        layout = self._kwargs["layout"]
        cin = x.shape[-1] if layout and layout[1] != "C" else x.shape[1]
        w = list(self._reg_params["weight"].shape)
        w[-1 if layout and layout[1] != "C" else 1] = \
            cin // self._kwargs["num_group"]
        return {"weight": tuple(w)}

    def hybrid_forward(self, F, x, weight, bias=None):
        """``mxnet_tpu/gluon/nn/conv_layers.py:76``."""
        if bias is None:
            out = F.Convolution(x, weight, name="fwd", **self._kwargs)
        else:
            out = F.Convolution(x, weight, bias, name="fwd", **self._kwargs)
        return self.act(out) if self.act is not None else out


class Conv2D(_Conv):
    """2D convolution (gluon/nn/conv_layers.py:257)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        assert layout in ("NCHW", "NHWC"), "layout must be NCHW or NHWC"
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 2
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class _Pooling(HybridBlock):
    """Base for pooling layers (gluon/nn/conv_layers.py:699)."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": _tuple(strides, len(pool_size)),
            "pad": _tuple(padding, len(pool_size)),
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
            "layout": layout}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, name="fwd", **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        assert layout in ("NCHW", "NHWC"), "layout must be NCHW or NHWC"
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 2
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", layout, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        assert layout in ("NCHW", "NHWC"), "layout must be NCHW or NHWC"
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 2
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", layout, count_include_pad, **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        assert layout in ("NCHW", "NHWC"), "layout must be NCHW or NHWC"
        super().__init__((1, 1), None, 0, True, True, "max", layout,
                         **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        assert layout in ("NCHW", "NHWC"), "layout must be NCHW or NHWC"
        super().__init__((1, 1), None, 0, True, True, "avg", layout,
                         **kwargs)

"""Gluon convolution and pooling layers (port of
``mxnet_tpu/gluon/nn/conv_layers.py:113-360``; parity:
python/mxnet/gluon/nn/conv_layers.py).

``Conv2D`` / ``MaxPool2D`` / ... take ``layout`` NCHW (OIHW weights) or
NHWC (OHWI weights, ``mxnet_tpu``'s channels-last parameter shape, so
carried weights load unchanged); the 1-D and 3-D layers and the transposed
convolutions are channels-first only, as there. A transposed convolution's
weight is (in_channels, channels / groups, *kernel). Without
``in_channels`` the weight waits for the first forward, which reads the
input's channels (deferred initialization).
"""
from __future__ import annotations

import numpy as _np

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _tuple(v, n):
    if isinstance(v, (int, _np.integer)):
        return (int(v),) * n
    # asymmetric (lo, hi) padding pairs pass through untouched
    return tuple(tuple(int(y) for y in x) if isinstance(x, (tuple, list))
                 else int(x) for x in v)


def _ktuple(kernel_size, n):
    return (kernel_size,) * n if isinstance(kernel_size, int) \
        else tuple(kernel_size)


class _Conv(HybridBlock):
    """Base for conv layers (reference gluon/nn/conv_layers.py:33);
    ``op_name`` "Convolution" or "Deconvolution"."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 prefix=None):
        super().__init__(prefix=prefix)
        ndim = len(kernel_size)
        self._op_name = op_name
        self._kwargs = {
            "kernel": kernel_size, "stride": _tuple(strides, ndim),
            "dilate": _tuple(dilation, ndim), "pad": _tuple(padding, ndim),
            "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = _tuple(adj, ndim)
        with self.name_scope():
            if op_name == "Deconvolution":
                wshape = (in_channels, channels // groups) + \
                    tuple(kernel_size)
            elif layout and layout[1] != "C":  # channels-last: OHWI weights
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
        last = bool(layout) and layout[1] != "C"
        cin = x.shape[-1] if last else x.shape[1]
        w = list(self._reg_params["weight"].shape)
        if self._op_name == "Deconvolution":
            w[0] = cin
        else:
            w[-1 if last else 1] = cin // self._kwargs["num_group"]
        return {"weight": tuple(w)}

    def hybrid_forward(self, F, x, weight, bias=None):
        """``mxnet_tpu/gluon/nn/conv_layers.py:76``."""
        op = getattr(F, self._op_name)
        if bias is None:
            out = op(x, weight, name="fwd", **self._kwargs)
        else:
            out = op(x, weight, bias, name="fwd", **self._kwargs)
        return self.act(out) if self.act is not None else out


class Conv1D(_Conv):
    """1D convolution (gluon/nn/conv_layers.py:177)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        assert layout == "NCW", "Only NCW layout is supported"
        super().__init__(channels, _ktuple(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv2D(_Conv):
    """2D convolution (gluon/nn/conv_layers.py:257)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        assert layout in ("NCHW", "NHWC"), "layout must be NCHW or NHWC"
        super().__init__(channels, _ktuple(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv3D(_Conv):
    """3D convolution (gluon/nn/conv_layers.py:341)."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        assert layout == "NCDHW", "Only NCDHW layout is supported"
        super().__init__(channels, _ktuple(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class _ConvTranspose(_Conv):
    """Transposed convolution: the output is
    ``(in - 1) * stride - 2 * pad + dilation * (kernel - 1) +
    output_padding + 1`` wide (gluon/nn/conv_layers.py:426-690)."""

    def __init__(self, ndim, layout, channels, kernel_size, strides,
                 padding, output_padding, dilation, groups, activation,
                 use_bias, weight_initializer, bias_initializer,
                 in_channels, **kwargs):
        if isinstance(output_padding, int):
            output_padding = (output_padding,) * ndim
        super().__init__(channels, _ktuple(kernel_size, ndim), strides,
                         padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, op_name="Deconvolution",
                         adj=output_padding, **kwargs)
        self.out_pad = output_padding


class Conv1DTranspose(_ConvTranspose):
    """Transposed 1D convolution (gluon/nn/conv_layers.py:426)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        assert layout == "NCW", "Only NCW layout is supported"
        super().__init__(1, layout, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, activation,
                         use_bias, weight_initializer, bias_initializer,
                         in_channels, **kwargs)


class Conv2DTranspose(_ConvTranspose):
    """Transposed 2D convolution (gluon/nn/conv_layers.py:514)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        assert layout == "NCHW", \
            "Deconvolution supports only NCHW (no NHWC kernel path)"
        super().__init__(2, layout, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, activation,
                         use_bias, weight_initializer, bias_initializer,
                         in_channels, **kwargs)


class Conv3DTranspose(_ConvTranspose):
    """Transposed 3D convolution (gluon/nn/conv_layers.py:606)."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        assert layout == "NCDHW", "Only NCDHW layout is supported"
        super().__init__(3, layout, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, activation,
                         use_bias, weight_initializer, bias_initializer,
                         in_channels, **kwargs)


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


_LAYOUTS = {1: ("NCW",), 2: ("NCHW", "NHWC"), 3: ("NCDHW",)}


def _check_layout(layout, ndim):
    assert layout in _LAYOUTS[ndim], \
        f"layout must be one of {_LAYOUTS[ndim]}, got {layout!r}"


class _MaxPool(_Pooling):
    def __init__(self, ndim, pool_size, strides, padding, layout, ceil_mode,
                 **kwargs):
        _check_layout(layout, ndim)
        super().__init__(_ktuple(pool_size, ndim), strides, padding,
                         ceil_mode, False, "max", layout, **kwargs)


class _AvgPool(_Pooling):
    def __init__(self, ndim, pool_size, strides, padding, layout, ceil_mode,
                 count_include_pad, **kwargs):
        _check_layout(layout, ndim)
        super().__init__(_ktuple(pool_size, ndim), strides, padding,
                         ceil_mode, False, "avg", layout, count_include_pad,
                         **kwargs)


class _GlobalPool(_Pooling):
    def __init__(self, ndim, pool_type, layout, **kwargs):
        _check_layout(layout, ndim)
        super().__init__((1,) * ndim, None, 0, True, True, pool_type,
                         layout, **kwargs)


class MaxPool1D(_MaxPool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(1, pool_size, strides, padding, layout, ceil_mode,
                         **kwargs)


class MaxPool2D(_MaxPool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(2, pool_size, strides, padding, layout, ceil_mode,
                         **kwargs)


class MaxPool3D(_MaxPool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(3, pool_size, strides, padding, layout, ceil_mode,
                         **kwargs)


class AvgPool1D(_AvgPool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(1, pool_size, strides, padding, layout, ceil_mode,
                         count_include_pad, **kwargs)


class AvgPool2D(_AvgPool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(2, pool_size, strides, padding, layout, ceil_mode,
                         count_include_pad, **kwargs)


class AvgPool3D(_AvgPool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(3, pool_size, strides, padding, layout, ceil_mode,
                         count_include_pad, **kwargs)


class GlobalMaxPool1D(_GlobalPool):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__(1, "max", layout, **kwargs)


class GlobalMaxPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(2, "max", layout, **kwargs)


class GlobalMaxPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(3, "max", layout, **kwargs)


class GlobalAvgPool1D(_GlobalPool):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__(1, "avg", layout, **kwargs)


class GlobalAvgPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(2, "avg", layout, **kwargs)


class GlobalAvgPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(3, "avg", layout, **kwargs)


class ReflectionPad2D(HybridBlock):
    """Pads an NCHW input's two spatial axes with the reflection of their
    edges (gluon/nn/conv_layers.py:1156): ``padding`` an int for every
    side, or the 8-tuple of (before, after) per axis."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        assert len(padding) == 8
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)

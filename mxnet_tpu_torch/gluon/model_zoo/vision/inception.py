"""Inception v3 at 299x299 (port of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``; parity:
python/mxnet/gluon/model_zoo/vision/inception.py): BatchNorm with epsilon
0.001, average pools that count their padding. Widths are deferred to the
first forward."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


class _Branches(HybridBlock):
    """Concats parallel branches along channel axis."""

    def __init__(self, branches, **kwargs):
        super().__init__(**kwargs)
        for i, b in enumerate(branches):
            setattr(self, f"branch{i}", b)
        self._n = len(branches)

    def hybrid_forward(self, F, x):
        outs = [getattr(self, f"branch{i}")(x) for i in range(self._n)]
        return F.Concat(*outs, dim=1)


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    for setting in conv_settings:
        kwargs = {}
        for k, v in zip(["channels", "kernel_size", "strides", "padding"],
                        setting):
            if v is not None:
                kwargs[k] = v
        out.add(_make_basic_conv(**kwargs))
    return out


def _make_A(pool_features, prefix):
    return _Branches([
        _make_branch(None, (64, 1, None, None)),
        _make_branch(None, (48, 1, None, None), (64, 5, None, 2)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, None, 1)),
        _make_branch("avg", (pool_features, 1, None, None)),
    ], prefix=prefix)


def _make_B(prefix):
    return _Branches([
        _make_branch(None, (384, 3, 2, None)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, 2, None)),
        _make_branch("max"),
    ], prefix=prefix)


def _make_C(channels_7x7, prefix):
    return _Branches([
        _make_branch(None, (192, 1, None, None)),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0))),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (192, (1, 7), None, (0, 3))),
        _make_branch("avg", (192, 1, None, None)),
    ], prefix=prefix)


def _make_D(prefix):
    return _Branches([
        _make_branch(None, (192, 1, None, None), (320, 3, 2, None)),
        _make_branch(None, (192, 1, None, None),
                     (192, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0)),
                     (192, 3, 2, None)),
        _make_branch("max"),
    ], prefix=prefix)


class _SplitConcat(HybridBlock):
    def __init__(self, trunk, heads, **kwargs):
        super().__init__(**kwargs)
        self.trunk = trunk
        for i, h in enumerate(heads):
            setattr(self, f"head{i}", h)
        self._n = len(heads)

    def hybrid_forward(self, F, x):
        x = self.trunk(x)
        outs = [getattr(self, f"head{i}")(x) for i in range(self._n)]
        return F.Concat(*outs, dim=1)


def _make_E(prefix):
    def branch_3x3():
        trunk = _make_branch(None, (384, 1, None, None))
        return _SplitConcat(trunk, [
            _make_branch(None, (384, (1, 3), None, (0, 1))),
            _make_branch(None, (384, (3, 1), None, (1, 0)))])

    def branch_3x3dbl():
        trunk = _make_branch(None, (448, 1, None, None), (384, 3, None, 1))
        return _SplitConcat(trunk, [
            _make_branch(None, (384, (1, 3), None, (0, 1))),
            _make_branch(None, (384, (3, 1), None, (1, 0)))])

    return _Branches([
        _make_branch(None, (320, 1, None, None)),
        branch_3x3(),
        branch_3x3dbl(),
        _make_branch("avg", (192, 1, None, None)),
    ], prefix=prefix)


class Inception3(HybridBlock):
    """Inception v3 (model_zoo/vision/inception.py:167)."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                               strides=2))
            self.features.add(_make_basic_conv(channels=32, kernel_size=3))
            self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                               padding=1))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80, kernel_size=1))
            self.features.add(_make_basic_conv(channels=192, kernel_size=3))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_make_E("E1_"))
            self.features.add(_make_E("E2_"))
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    net = Inception3(**kwargs)
    if pretrained:
        raise RuntimeError("pretrained weights are unavailable offline; "
                           "initialize() and train, or load_numpy_params()")
    return net

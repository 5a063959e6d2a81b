"""ResNet V1/V2 for the model zoo (port of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``; parity:
python/mxnet/gluon/model_zoo/vision/resnet.py).

The same classes, constructors and parameter names as ``mxnet_tpu``, letter
for letter, with its extensions: ``layout='NHWC'`` runs the whole network
channels-last (inputs stay NCHW at the API edge and are transposed once on
entry) and ``stem='s2d'`` replaces the 7x7/2 stem conv with
space-to-depth(2) and a 4x4/1 conv padded ((2, 1), (2, 1)). Unlike the JAX
package every layer is built with its input width, so the net is whole at
``initialize``; the name -> shape map equals ``mxnet_tpu``'s after its
first forward. Like ``mxnet_tpu``, the forward does not call the fused
conv + BN-statistics kernel (K3): its convs are library convs.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ....ops import math as _math

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]

_IMAGE_CHANNELS = 3


def _conv3x3(channels, stride, in_channels, layout="NCHW"):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, layout=layout)


def _bn_axis(layout):
    return 3 if layout == "NHWC" else 1


def _bn(channels, layout, **kwargs):
    return nn.BatchNorm(axis=_bn_axis(layout), in_channels=channels, **kwargs)


def _add_stem(features, channels0, thumbnail, stem, layout):
    """Append the shared input stem. stem='s2d' folds the stride-2 7x7
    into s2d(2) + 4x4/1 with (2, 1) pads (7 padded to 8)."""
    if thumbnail:
        features.add(_conv3x3(channels0, 1, _IMAGE_CHANNELS, layout))
        return
    if stem == "s2d":
        # 224^2 RGB -> s2d(2) -> 112^2 x 12
        features.add(nn.Conv2D(channels0, 4, 1, ((2, 1), (2, 1)),
                               use_bias=False, in_channels=4 * _IMAGE_CHANNELS,
                               layout=layout))
    else:
        features.add(nn.Conv2D(channels0, 7, 2, 3, use_bias=False,
                               in_channels=_IMAGE_CHANNELS, layout=layout))
    features.add(_bn(channels0, layout))
    features.add(nn.Activation("relu"))
    features.add(nn.MaxPool2D(3, 2, 1, layout=layout))


def _input_preamble(x, stem, layout):
    """NCHW API input -> the internal layout (one transform at the edge),
    contiguous."""
    if stem == "s2d":
        x = _math.space_to_depth(x, block_size=2)
    if layout == "NHWC":
        x = _math.transpose(x, axes=(0, 2, 3, 1)).contiguous()
    return x


class BasicBlockV1(HybridBlock):
    """ResNet V1 basic block (model_zoo/vision/resnet.py:40)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, layout))
        self.body.add(_bn(channels, layout))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout))
        self.body.add(_bn(channels, layout))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(_bn(channels, layout))
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(residual + x, act_type="relu")


class BottleneckV1(HybridBlock):
    """ResNet V1 bottleneck (model_zoo/vision/resnet.py:84). Its 1x1 convs
    keep their biases, as in MXNet; the stride sits on the first 1x1, so
    the 3x3 conv (``body[3]``) is always stride 1."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(mid, kernel_size=1, strides=stride,
                                in_channels=in_channels, layout=layout))
        self.body.add(_bn(mid, layout))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(mid, 1, mid, layout))
        self.body.add(_bn(mid, layout))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                in_channels=mid, layout=layout))
        self.body.add(_bn(channels, layout))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(_bn(channels, layout))
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    """ResNet V2 pre-activation basic block
    (model_zoo/vision/resnet.py:137)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        self.bn1 = _bn(in_channels, layout)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout)
        self.bn2 = _bn(channels, layout)
        self.conv2 = _conv3x3(channels, 1, channels, layout)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.Activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    """ResNet V2 pre-activation bottleneck
    (model_zoo/vision/resnet.py:191)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        self.bn1 = _bn(in_channels, layout)
        self.conv1 = nn.Conv2D(mid, kernel_size=1, strides=1,
                               use_bias=False, in_channels=in_channels,
                               layout=layout)
        self.bn2 = _bn(mid, layout)
        self.conv2 = _conv3x3(mid, stride, mid, layout)
        self.bn3 = _bn(mid, layout)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False, in_channels=mid, layout=layout)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.Activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        x = F.Activation(self.bn3(x), act_type="relu")
        x = self.conv3(x)
        return x + residual


def _make_layer(block, layers, channels, stride, stage_index, in_channels,
                layout):
    layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
    with layer.name_scope():
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, layout=layout, prefix=""))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels,
                            layout=layout, prefix=""))
    return layer


class ResNetV1(HybridBlock):
    """ResNet V1 (model_zoo/vision/resnet.py:250). Input (N, 3, H, W);
    output (N, classes)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", stem="conv7", **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        assert stem in ("conv7", "s2d")
        assert not (thumbnail and stem == "s2d"), \
            "stem='s2d' replaces the 7x7 stem; thumbnail nets have none"
        self._layout = layout
        self._stem = stem
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            _add_stem(self.features, channels[0], thumbnail, stem, layout)
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(_make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    channels[i], layout))
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.output = nn.Dense(classes, in_units=channels[-1])

    def forward(self, x):
        x = _input_preamble(x, self._stem, self._layout)
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    """ResNet V2 (model_zoo/vision/resnet.py:318). Input (N, 3, H, W);
    output (N, classes)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", stem="conv7", **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        assert stem == "conv7", \
            "s2d stem is V1-only: V2's input BatchNorm must normalize raw " \
            "channels, and s2d before it would regroup them per pixel parity"
        self._layout = layout
        self._stem = stem
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_bn(_IMAGE_CHANNELS, layout, scale=False,
                                  center=False))
            _add_stem(self.features, channels[0], thumbnail, stem, layout)
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(_make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels, layout))
                in_channels = channels[i + 1]
            self.features.add(_bn(in_channels, layout))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels)

    def forward(self, x):
        x = _input_preamble(x, self._stem, self._layout)
        return self.output(self.features(x))


# net depth -> (block spec, layers, channels)
resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """Constructor by (version, depth) (model_zoo/vision/resnet.py:385).
    The net is returned uninitialized: call ``initialize``."""
    assert num_layers in resnet_spec, \
        f"Invalid number of layers: {num_layers}. Options are " \
        f"{sorted(resnet_spec)}"
    block_type, layers, channels = resnet_spec[num_layers]
    assert 1 <= version <= 2, \
        f"Invalid resnet version: {version}. Options are 1 and 2."
    resnet_class = resnet_net_versions[version - 1]
    block_class = resnet_block_versions[version - 1][block_type]
    net = resnet_class(block_class, layers, channels, **kwargs)
    if pretrained:
        raise RuntimeError("pretrained weights are unavailable offline; "
                           "initialize() and train, or load_numpy_params()")
    return net


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)

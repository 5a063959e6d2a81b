"""ResNet vision slice of the PyTorch port against mxnet_tpu, on the CPU.

The ops (convolution, pooling, batch_norm, space_to_depth), the layers and
whole narrow ResNets get the same numpy inputs and carried weights in both
packages. Outputs agree within 1e-4 of their scale (f32 sums taken in
another order) unless stated; space_to_depth is a permutation and agrees
bitwise. The port builds every layer with its input width, so the
name -> shape maps of resnet50_v1/v2 are compared with mxnet_tpu's after
its first forward (which resolves its deferred shapes).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import gluon as jgluon  # noqa: E402
from mxnet_tpu.gluon.model_zoo import vision as jvision  # noqa: E402
from mxnet_tpu.ops import math as jmath, nn as jops  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import autograd as tautograd, serving  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tnn  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision  # noqa: E402
from mxnet_tpu_torch.ops import math as tmath, nn as tops  # noqa: E402

TOL = 1e-4


def _close(got, want, tol=TOL):
    """|got - want| <= tol * max(1, max|want|), elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _nhwc(a):
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------- ops
CONV_CASES = [
    # name, kernel, params
    ("asym_pad", (4, 4), dict(pad=((2, 1), (1, 0)), stride=(1, 1),
                              dilate=(1, 1), num_group=1)),
    ("groups_stride_dilate", (3, 3), dict(pad=(1, 2), stride=(2, 1),
                                          dilate=(2, 1), num_group=2)),
]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("name,kernel,params", CONV_CASES,
                         ids=[c[0] for c in CONV_CASES])
def test_convolution(layout, name, kernel, params):
    rng = np.random.RandomState(len(name))
    cin, cout = 4, 6
    x = rng.randn(2, cin, 9, 10).astype(np.float32)
    w = (rng.randn(cout, cin // params["num_group"], *kernel) * 0.2
         ).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    if layout == "NHWC":
        x, w = _nhwc(x), _nhwc(w)          # OIHW -> OHWI
    kw = dict(kernel=kernel, layout=layout, **params)
    want = jops._convolution(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             **kw)
    got = tops.convolution(_t(x), _t(w), _t(b), **kw)
    assert got.is_contiguous()
    _close(got.numpy(), want)


POOL_CASES = [
    # name, params
    ("max_valid", dict(pool_type="max", kernel=(3, 3), stride=(2, 2),
                       pad=(1, 1))),
    ("avg_valid_incl_pad", dict(pool_type="avg", kernel=(3, 3),
                                stride=(2, 2), pad=(1, 1))),
    ("avg_valid_excl_pad", dict(pool_type="avg", kernel=(3, 3),
                                stride=(2, 2), pad=(1, 1),
                                count_include_pad=False)),
    ("max_full", dict(pool_type="max", kernel=(3, 3), stride=(2, 2),
                      pad=(1, 1), pooling_convention="full")),
    ("avg_full_incl_pad", dict(pool_type="avg", kernel=(3, 3),
                               stride=(2, 2), pad=(1, 1),
                               pooling_convention="full")),
    ("avg_full_excl_pad", dict(pool_type="avg", kernel=(3, 3),
                               stride=(2, 2), pad=(1, 1),
                               pooling_convention="full",
                               count_include_pad=False)),
    ("sum_valid", dict(pool_type="sum", kernel=(2, 2), stride=(2, 2))),
    ("global_max", dict(pool_type="max", global_pool=True)),
    ("global_avg", dict(pool_type="avg", global_pool=True)),
]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("name,params", POOL_CASES,
                         ids=[c[0] for c in POOL_CASES])
def test_pooling(layout, name, params):
    x = np.random.RandomState(3).randn(2, 3, 10, 9).astype(np.float32)
    if layout == "NHWC":
        x = _nhwc(x)
    want = jops._pooling(jnp.asarray(x), layout=layout, **params)
    got = tops.pooling(_t(x), layout=layout, **params)
    _close(got.numpy(), want)


@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("axis", [1, 3])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm(train, axis, fix_gamma):
    rng = np.random.RandomState(axis)
    x = (rng.randn(4, 5, 6, 3) * 2 + 1).astype(np.float32)
    c = x.shape[axis]
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    mm = rng.randn(c).astype(np.float32)
    mv = (rng.rand(c) + 0.5).astype(np.float32)
    kw = dict(eps=1e-5, momentum=0.9, fix_gamma=fix_gamma, axis=axis,
              _train=train)
    want = jops._batch_norm(*map(jnp.asarray, (x, gamma, beta, mm, mv)),
                            **kw)
    got = tops.batch_norm(*map(_t, (x, gamma, beta, mm, mv)), **kw)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    if not train:
        np.testing.assert_array_equal(got[1].numpy(), mm)


def test_space_to_depth_bitwise_and_channel_order():
    x = np.random.RandomState(4).randn(2, 3, 8, 6).astype(np.float32)
    want = np.asarray(jmath._space_to_depth(jnp.asarray(x), block_size=2))
    got = tmath.space_to_depth(_t(x), block_size=2).numpy()
    np.testing.assert_array_equal(got, want)
    # channels come out (bh, bw, C): pixel_unshuffle's (C, bh, bw) differs
    unshuffled = torch.nn.functional.pixel_unshuffle(_t(x), 2).numpy()
    assert not np.array_equal(unshuffled, want)
    np.testing.assert_array_equal(got[:, :3], x[:, :, 0::2, 0::2])


def test_transpose_and_flatten():
    x = np.random.RandomState(5).randn(2, 3, 4, 5).astype(np.float32)
    np.testing.assert_array_equal(
        tmath.transpose(_t(x), axes=(0, 2, 3, 1)).numpy(),
        np.asarray(jmath._transpose(jnp.asarray(x), axes=(0, 2, 3, 1))))
    np.testing.assert_array_equal(tmath.transpose(_t(x)).numpy(), x.T)
    assert tuple(tops.flatten(_t(x)).shape) == (2, 60)


# ---------------------------------------------------------------- layers
def test_batchnorm_layer_train_mode_writes_running_stats():
    x = (np.random.RandomState(6).randn(4, 5, 5, 3) * 3 - 1).astype(
        np.float32)
    jb = jgluon.nn.BatchNorm(axis=3, in_channels=3, prefix="bn_")
    jb.initialize()
    tb = tnn.BatchNorm(axis=3, in_channels=3, prefix="bn_")
    tb.initialize(mt.init.Xavier(), ctx=mt.cpu())
    assert (tb.running_mean == 0).all() and (tb.running_var == 1).all()
    for name, p in tb._param_objects().items():
        assert p.grad_req == jb.collect_params()[name].grad_req, name
    with mx.autograd.train_mode():
        want = jb(mx.nd.array(x)).asnumpy()
    with tautograd.train_mode(), torch.inference_mode():
        got = tb(_t(x)).numpy()
    _close(got, want)
    for stat in ("running_mean", "running_var"):
        _close(getattr(tb, stat).numpy(),
               jb.collect_params()["bn_" + stat].data().asnumpy())
        assert not np.allclose(getattr(tb, stat).numpy(),
                               0.0 if stat == "running_mean" else 1.0)
    # outside train mode the running statistics are used and kept;
    # record() turns training on only inside its scope, as in MXNet
    with tautograd.record():
        assert tautograd.is_training()
    assert not tautograd.is_training()
    before = tb.running_mean.clone()
    _close(tb(_t(x)).detach().numpy(), jb(mx.nd.array(x)).asnumpy())
    assert torch.equal(tb.running_mean, before)


def test_batchnorm_cast_keeps_float32_under_float16():
    tb = tnn.BatchNorm(in_channels=4)
    tb.initialize(ctx=mt.cpu())
    tb.cast("float16")
    assert tb.gamma.dtype == torch.float32
    tb.cast("bfloat16")
    assert tb.gamma.dtype == torch.bfloat16
    conv = tnn.Conv2D(4, 3, in_channels=4)
    conv.initialize(ctx=mt.cpu())
    conv.cast("float16")
    assert conv.weight.dtype == torch.float16


# -------------------------------------------------------------- networks
NARROW = dict(layers=[1, 1, 1, 1], channels=[8, 16, 32, 64, 128],
              classes=10)
NET_CASES = [(1, blk, layout, stem)
             for blk in ("basic_block", "bottle_neck")
             for layout in ("NCHW", "NHWC") for stem in ("conv7", "s2d")]
NET_CASES += [(2, blk, layout, "conv7")
              for blk in ("basic_block", "bottle_neck")
              for layout in ("NCHW", "NHWC")]


def _build(pkg, version, block, layout, stem, prefix="net_"):
    zoo = (jvision if pkg == "jax" else tvision).resnet
    return zoo.resnet_net_versions[version - 1](
        zoo.resnet_block_versions[version - 1][block], layout=layout,
        stem=stem, prefix=prefix, **NARROW)


def _random_values(jnet, seed):
    """Weights ~ N(0, 1/fan_in), running stats and BN affines near their
    neutral values but random, so every BN really acts."""
    rng = np.random.RandomState(seed)
    values = {}
    for name, p in jnet.collect_params().items():
        shape = p.shape
        if name.endswith("weight"):
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif name.endswith("running_var") or name.endswith("gamma"):
            v = rng.rand(*shape) + 0.5
        else:                     # bias, beta, running_mean
            v = rng.randn(*shape) * 0.1
        values[name] = v.astype(np.float32)
        p.set_data(mx.nd.array(values[name]))
    return values


@pytest.mark.parametrize("version,block,layout,stem", NET_CASES,
                         ids=[f"v{v}_{b}_{lay}_{s}"
                              for v, b, lay, s in NET_CASES])
def test_narrow_resnet_matches(version, block, layout, stem):
    x = np.random.RandomState(7).rand(2, 3, 32, 32).astype(np.float32)
    jnet = _build("jax", version, block, layout, stem)
    jnet.initialize(mx.init.Zero())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jnet(mx.nd.array(x[:1]))          # resolves the deferred shapes
    values = _random_values(jnet, seed=version * 10 + len(block))
    tnet = _build("torch", version, block, layout, stem)
    tnet.initialize(ctx=mt.cpu())
    tnet.load_numpy_params(values)
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jnet(mx.nd.array(x)).asnumpy()
    with torch.inference_mode():
        got = tnet(_t(x)).numpy()
    assert got.shape == (2, NARROW["classes"])
    _close(got, want)


SHAPE_CASES = [(1, "NCHW", "conv7"), (1, "NHWC", "conv7"),
               (1, "NCHW", "s2d"), (1, "NHWC", "s2d"),
               (2, "NCHW", "conv7"), (2, "NHWC", "conv7")]


@pytest.mark.parametrize("version,layout,stem", SHAPE_CASES,
                         ids=[f"v{v}_{lay}_{s}" for v, lay, s in SHAPE_CASES])
def test_resnet50_names_and_shapes(version, layout, stem):
    ctor = f"resnet50_v{version}"
    jnet = getattr(jvision, ctor)(layout=layout, stem=stem, prefix="r50_")
    jnet.initialize(mx.init.Zero())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jnet(mx.nd.zeros((1, 3, 16, 16)))   # resolves the deferred shapes
    want = {k: tuple(p.shape) for k, p in jnet.collect_params().items()}
    tnet = getattr(tvision, ctor)(layout=layout, stem=stem, prefix="r50_")
    got = {k: p.shape for k, p in tnet._param_objects().items()}
    assert list(got) == list(want)
    assert got == want


def test_get_model_builds_and_rejects_unknown():
    net = tvision.get_model("resnet50_v1", classes=10)
    shapes = {k: p.shape for k, p in net._param_objects().items()}
    assert shapes[net.prefix + "dense0_weight"] == (10, 2048)
    assert len(shapes) == len(jvision.get_model(
        "resnet50_v1", classes=10).collect_params())
    with pytest.raises(ValueError, match="not supported"):
        tvision.get_model("vgg17")        # vgg16 is in the table


def test_predictor_serves_a_small_resnet():
    net = _build("torch", 1, "bottle_neck", "NHWC", "s2d")
    net.initialize(mt.init.Xavier(), ctx=mt.cpu(),
                   generator=torch.Generator().manual_seed(0))
    pred = serving.Predictor.from_block(
        net, input_shapes={"data": (3, 32, 32)}, batch_sizes=(1, 4),
        ctx=mt.cpu())
    x = np.random.RandomState(8).rand(4, 3, 32, 32)     # float64 in
    (full,) = pred.predict(x)
    (part,) = pred.predict(x[:3])                       # padded to 4
    with torch.inference_mode():
        direct = net(torch.from_numpy(x).float())
    assert full.dtype == torch.float32 and full.shape == (4, 10)
    assert torch.equal(full, direct)
    assert torch.equal(part, full[:3])

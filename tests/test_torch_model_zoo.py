"""The vision model zoo of the PyTorch port against mxnet_tpu's, on the CPU.

Each family is built in both packages with deferred widths and the same
prefix (classes=10; its narrowest form where the constructor has widths,
at the smallest input it accepts), mxnet_tpu's hybridized forward resolves
its shapes, and its weights are carried into the port with
``load_numpy_params`` (strict: the names and, once the port's first
forward has resolved them, the shapes agree). Predict-mode logits agree
within 1e-4 of their scale (f32 sums taken in another order). Inception
v3 accepts nothing below 299x299, where mxnet_tpu's forward takes ~40 s on
the CPU: its five block kinds are compared at small sizes instead, and the
port's whole network runs at 299x299. VGG-16's and AlexNet's name ->
shape maps and parameter counts are held to mxnet_tpu's at full width,
1000 classes.
"""
import inspect
import re
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.gluon import block as jblock  # noqa: E402
from mxnet_tpu.gluon.model_zoo import vision as jv  # noqa: E402
from mxnet_tpu.gluon.model_zoo.vision import inception as jinc  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.gluon import block as tblock  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import vision as tv  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo.vision import (  # noqa: E402
    inception as tinc)

TOL = 1e-4


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _jax_forward(jnet, x):
    jnet.initialize()
    jnet.hybridize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jnet(mx.nd.array(x)).asnumpy()


def _carried(jnet, tnet, x):
    """The port's predict-mode output, with mxnet_tpu's weights carried
    into its deferred parameters, beside mxnet_tpu's own output."""
    want = _jax_forward(jnet, x)
    tnet.initialize(ctx=mt.cpu())
    params = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnet.load_numpy_params(params)
    assert list(tnet.collect_params()) == list(params)
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x)).numpy()
    return got, want


def _image(side, seed=0):
    return np.random.RandomState(seed).rand(1, 3, side, side).astype(
        np.float32)


# name, constructor (lib's vision module -> net), smallest input side
FAMILIES = [
    ("vgg", lambda v: v.VGG([1, 1, 1, 1, 1], [8, 8, 16, 16, 16], classes=10,
                            prefix="vgg_"), 32),
    ("vgg_bn", lambda v: v.VGG([1, 1, 1, 1, 1], [8, 8, 16, 16, 16],
                               classes=10, batch_norm=True,
                               prefix="vggbn_"), 32),
    ("alexnet", lambda v: v.alexnet(classes=10, prefix="alex_"), 63),
    ("squeezenet1.0", lambda v: v.squeezenet1_0(classes=10,
                                                prefix="sq10_"), 35),
    ("squeezenet1.1", lambda v: v.squeezenet1_1(classes=10,
                                                prefix="sq11_"), 35),
    ("mobilenet0.25", lambda v: v.mobilenet0_25(classes=10,
                                                prefix="mb_"), 32),
    ("mobilenetv2_0.25", lambda v: v.mobilenet_v2_0_25(classes=10,
                                                       prefix="mb2_"), 32),
    ("densenet", lambda v: v.DenseNet(8, 4, [1, 2, 1, 1], bn_size=2,
                                      classes=10, prefix="dn_"), 221),
]


@pytest.mark.parametrize("name,make,side", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_family_narrow_predict_matches(name, make, side):
    got, want = _carried(make(jv), make(tv), _image(side))
    assert got.shape == (1, 10)
    _close(got, want)


INCEPTION_BLOCKS = [
    ("A", lambda m: m._make_A(32, "A1_"), (1, 8, 9, 9)),
    ("B", lambda m: m._make_B("B_"), (1, 8, 9, 9)),
    ("C", lambda m: m._make_C(16, "C1_"), (1, 8, 9, 9)),
    ("D", lambda m: m._make_D("D_"), (1, 8, 9, 9)),
    ("E", lambda m: m._make_E("E1_"), (1, 8, 5, 5)),
]


@pytest.mark.parametrize("kind,make,shape", INCEPTION_BLOCKS,
                         ids=[b[0] for b in INCEPTION_BLOCKS])
def test_inception_blocks_match(kind, make, shape):
    """A block's branches are built before it, at the top level, so their
    names come from each package's global counter: both start from 0."""
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    jblock._BlockScope._global_counter.clear()
    jnet = make(jinc)
    tblock._BlockScope._global_counter.clear()
    got, want = _carried(jnet, make(tinc), x)
    _close(got, want)


def _jax_shapes(jnet, side):
    _jax_forward(jnet, np.zeros((1, 3, side, side), np.float32))
    return {k: tuple(p.shape) for k, p in jnet.collect_params().items()}


def _port_shapes(tnet, side):
    tnet.initialize(ctx=mt.cpu())
    with torch.inference_mode():
        out = tnet(torch.zeros(1, 3, side, side))
    assert tuple(out.shape) == (1, 1000) and bool(torch.isfinite(out).all())
    return {k: tuple(t.shape) for k, t in tnet.collect_params().items()}


@pytest.mark.parametrize("name,side,count", [
    ("vgg16", 224, 138_357_544), ("alexnet", 224, 61_100_840)])
def test_full_width_shapes_and_count(name, side, count):
    """At full width and 1000 classes, the port's name -> shape map after
    its first forward equals mxnet_tpu's after shape inference; VGG-16
    holds 138,357,544 parameters in both, AlexNet 61,100,840."""
    want = _jax_shapes(jv.get_model(name, prefix="full_"), side)
    got = _port_shapes(tv.get_model(name, prefix="full_"), side)
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == count


def test_inception_v3_runs_at_299():
    """The smallest input Inception v3 takes: its last average pool needs
    an 8x8 map, which 299x299 gives."""
    net = tv.inception_v3(classes=10, prefix="inc_")
    net.initialize(ctx=mt.cpu(), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        out = net(torch.from_numpy(_image(299)))
    assert tuple(out.shape) == (1, 10) and bool(torch.isfinite(out).all())
    assert net.collect_params()["inc_dense0_weight"].shape == (10, 2048)
    with pytest.raises(RuntimeError):
        with torch.inference_mode():
            net(torch.zeros(1, 3, 298, 298))


def test_get_model_name_set_and_pretrained():
    want = set(re.findall(r'"([a-z0-9_.]+)":',
                          inspect.getsource(jv.get_model)))
    assert set(tv._MODELS) == want and len(want) == 34
    with pytest.raises(ValueError, match="not supported"):
        tv.get_model("vgg17")
    for name in ("vgg16", "alexnet", "squeezenet1.1", "mobilenet1.0",
                 "mobilenetv2_1.0", "densenet121", "inceptionv3"):
        with pytest.raises(RuntimeError, match="pretrained"):
            tv.get_model(name, pretrained=True)


@pytest.mark.parametrize("name", sorted(
    ["vgg11", "vgg13", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn",
     "vgg19_bn", "densenet161", "densenet169", "densenet201",
     "mobilenet1.0", "mobilenet0.75", "mobilenet0.5", "mobilenetv2_1.0",
     "mobilenetv2_0.75", "mobilenetv2_0.5", "inceptionv3"]))
def test_every_model_builds_deferred_with_the_same_names(name):
    """Every other name of the table builds in both packages with the
    same parameter names, in order, every weight deferred (widths 0)."""
    j = jv.get_model(name, classes=10, prefix="m_")
    t = tv.get_model(name, classes=10, prefix="m_")
    jp, tp = j.collect_params(), t.collect_params().param_objects
    assert list(jp) == list(tp)
    for k, p in tp.items():
        assert p.shape == tuple(jp[k].shape), k
    t.initialize(ctx=mt.cpu())
    weights = [p for k, p in tp.items() if k.endswith("weight")]
    assert weights and all(p._tensor() is None for p in weights)
    with pytest.raises(mt.gluon.DeferredInitializationError):
        weights[0].data()


def test_vgg_initializers():
    """Convs Xavier(gaussian, out, 2), Dense layers N(0, 0.01), zero
    biases (mxnet_tpu/gluon/model_zoo/vision/vgg.py:22-27), from the
    generator given to initialize."""
    def build(seed):
        net = tv.VGG([1, 1, 1, 1, 1], [8, 8, 16, 16, 16], classes=10,
                     prefix="v_")
        net.initialize(ctx=mt.cpu(),
                       generator=torch.Generator().manual_seed(seed))
        net(torch.zeros(1, 3, 32, 32))
        return net.collect_params()

    a, b = build(0), build(0)
    assert all(torch.equal(a[k], b[k]) for k in a)
    conv = a["v_conv4_weight"]                # (16, 16, 3, 3)
    fan_out = 16 * 9
    assert abs(conv.std().item() / np.sqrt(2 / fan_out) - 1) < 0.15
    dense = a["v_dense0_weight"]              # (4096, 16)
    assert abs(dense.std().item() / 0.01 - 1) < 0.05
    assert abs(dense.mean().item()) < 1e-3
    assert all((a[k] == 0).all() for k in a if k.endswith("bias"))

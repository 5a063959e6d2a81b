"""Gluon layers of the PyTorch port against mxnet_tpu's, on the CPU.

Each pair of blocks is built with the same prefix; random weights made
with numpy are set into the JAX block and carried into the port with
``load_numpy_params`` (strict, so the names must agree letter for letter).
Outputs agree within 1e-5 (f32 sums taken in another order).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import gluon as jgluon  # noqa: E402
from mxnet_tpu.gluon import contrib as jcontrib  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.gluon import contrib as tcontrib, nn as tnn  # noqa: E402

TOL = 1e-5


def _carry(jblk, tblk, seed, warm=None):
    """Random numpy weights -> both blocks. ``warm`` materializes the JAX
    block's deferred shapes first."""
    if warm is not None:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # JAX flash: CPU fallback
            jblk(mx.nd.array(warm))
    rng = np.random.RandomState(seed)
    values = {}
    for name, p in jblk.collect_params().items():
        values[name] = (rng.randn(*p.shape) * 0.3).astype(np.float32)
        p.set_data(mx.nd.array(values[name]))
    tblk.initialize(ctx=mt.cpu())
    tblk.load_numpy_params(values)
    assert list(tblk.collect_params()) == list(jblk.collect_params())


def _both(jblk, tblk, x):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # JAX flash: CPU fallback warning
        want = jblk(mx.nd.array(x)).asnumpy()
    with torch.inference_mode():
        got = tblk(torch.from_numpy(x)).numpy()
    return got, want


def test_dense_gelu():
    jb = jgluon.nn.Dense(24, activation="gelu", flatten=False, in_units=16,
                         prefix="d_")
    jb.initialize()
    tb = tnn.Dense(24, activation="gelu", flatten=False, in_units=16,
                   prefix="d_")
    _carry(jb, tb, seed=0)
    x = np.random.RandomState(1).randn(2, 5, 16).astype(np.float32)
    got, want = _both(jb, tb, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_dense_flatten():
    jb = jgluon.nn.Dense(6, in_units=12, prefix="f_")
    jb.initialize()
    tb = tnn.Dense(6, in_units=12, prefix="f_")
    _carry(jb, tb, seed=2)
    x = np.random.RandomState(3).randn(3, 3, 4).astype(np.float32)
    got, want = _both(jb, tb, x)
    assert got.shape == (3, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_layer_norm():
    jb = jgluon.nn.LayerNorm(in_channels=32, prefix="ln_")
    jb.initialize()
    tb = tnn.LayerNorm(in_channels=32, prefix="ln_")
    _carry(jb, tb, seed=4)
    x = (np.random.RandomState(5).randn(2, 7, 32) * 3 + 1).astype(np.float32)
    got, want = _both(jb, tb, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_embedding_clips_out_of_range_ids():
    jb = jgluon.nn.Embedding(10, 8, prefix="e_")
    jb.initialize()
    tb = tnn.Embedding(10, 8, prefix="e_")
    _carry(jb, tb, seed=6)
    ids = np.array([[0, 3, 9, 10, 57], [-1, -20, 4, 9, 2]], np.int32)
    want = jb(mx.nd.array(ids, dtype="int32")).asnumpy()
    got = tb(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0)
    table = tb.weight.detach().numpy()
    np.testing.assert_array_equal(got[0, 3], table[9])    # 10 -> 9
    np.testing.assert_array_equal(got[1, 1], table[0])    # -20 -> 0


def test_gelu_forms():
    """Activation('gelu') is the tanh approximation (jax.nn.gelu's
    default); LeakyReLU(act_type='gelu'), reached by nn.GELU, is exact."""
    x = np.linspace(-4, 4, 101, dtype=np.float32).reshape(1, 101)
    got_tanh, want_tanh = _both(jgluon.nn.Activation("gelu"),
                                tnn.Activation("gelu"), x)
    got_erf, want_erf = _both(jgluon.nn.GELU(), tnn.GELU(), x)
    np.testing.assert_allclose(got_tanh, want_tanh, rtol=0, atol=TOL)
    np.testing.assert_allclose(got_erf, want_erf, rtol=0, atol=TOL)
    t = torch.from_numpy(x)
    tanh_form = 0.5 * t * (1 + torch.tanh(
        np.sqrt(2 / np.pi) * (t + 0.044715 * t ** 3)))
    np.testing.assert_allclose(got_tanh, tanh_form.numpy(), rtol=0,
                               atol=TOL)
    # the two forms differ by more than the tolerance, so each comparison
    # above tells them apart
    assert np.abs(got_tanh - got_erf).max() > 1e-4
    want_leaky = mx.nd.LeakyReLU(mx.nd.array(x), act_type="gelu").asnumpy()
    got_leaky = mt.ops.nn.leaky_relu(t, act_type="gelu").numpy()
    np.testing.assert_allclose(got_leaky, want_leaky, rtol=0, atol=TOL)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign", "silu", "swish", "leaky"])
def test_other_activations(act):
    x = np.linspace(-5, 5, 64, dtype=np.float32).reshape(2, 32)
    if act == "leaky":
        jb, tb = jgluon.nn.LeakyReLU(0.1), tnn.LeakyReLU(0.1)
    else:
        jb, tb = jgluon.nn.Activation(act), tnn.Activation(act)
    got, want = _both(jb, tb, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_multi_head_attention(impl):
    jb = jcontrib.MultiHeadAttention(32, 4, impl=impl, causal=True,
                                     prefix="mha_")
    jb.initialize()
    tb = tcontrib.nn.MultiHeadAttention(32, 4, impl=impl, causal=True,
                                        prefix="mha_")
    _carry(jb, tb, seed=7, warm=np.zeros((1, 4, 32), np.float32))
    x = np.random.RandomState(8).randn(2, 24, 32).astype(np.float32)
    got, want = _both(jb, tb, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_multi_head_attention_ring_not_ported():
    """impl='ring' is ported (tests/test_torch_ring_attention.py runs it
    over 4 ranks); with no sp mesh it is single-device attention, as
    mxnet_tpu's parallel.attention makes it: the dense composition on the
    CPU, equal to impl='dense'."""
    ring = tcontrib.nn.MultiHeadAttention(32, 4, impl="ring", causal=True,
                                          prefix="mha_")
    dense = tcontrib.nn.MultiHeadAttention(32, 4, impl="dense", causal=True,
                                           prefix="mha_")
    for b in (ring, dense):
        b.initialize(ctx=mt.cpu())
    dense.load_numpy_params({k: p.detach().numpy() for k, p in
                             ring.collect_params().items()})
    x = torch.tensor(np.random.RandomState(3).randn(2, 8, 32)
                     .astype(np.float32))
    assert torch.equal(ring(x), dense(x))
    with pytest.raises(ValueError, match="unknown impl"):
        tcontrib.nn.MultiHeadAttention(32, 4, impl="rings")


def test_load_numpy_params_strict_lists_names():
    tb = tnn.Dense(4, in_units=3, prefix="s_")
    tb.initialize(ctx=mt.cpu())
    good = {"s_weight": np.ones((4, 3), np.float32),
            "s_bias": np.zeros(4, np.float32)}
    with pytest.raises(mt.MXNetError, match="s_bias"):
        tb.load_numpy_params({"s_weight": good["s_weight"]})
    with pytest.raises(mt.MXNetError, match="s_extra"):
        tb.load_numpy_params(dict(good, s_extra=np.zeros(1)))
    with pytest.raises(mt.MXNetError, match="shape mismatch"):
        tb.load_numpy_params(dict(good, s_weight=np.ones((3, 4))))
    tb.load_numpy_params({"s_weight": good["s_weight"]}, strict=False)
    assert (tb.weight == 1).all()


def test_cast_and_dtype_of_carried_weights():
    tb = tnn.Dense(4, in_units=3, prefix="c_")
    tb.initialize(ctx=mt.cpu())
    tb.cast("bfloat16")
    tb.load_numpy_params({"c_weight": np.full((4, 3), 0.5, np.float32),
                          "c_bias": np.zeros(4, np.float32)})
    assert tb.weight.dtype == torch.bfloat16 and (tb.weight == 0.5).all()
    out = tb(torch.ones(2, 3, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16


def test_initializers_follow_the_generator():
    def build(seed):
        blk = tnn.Dense(8, in_units=8, prefix="g_")
        blk.initialize(mt.init.Xavier(), ctx=mt.cpu(),
                       generator=torch.Generator().manual_seed(seed))
        return blk

    a, b, c = build(0), build(0), build(1)
    assert torch.equal(a.weight, b.weight)
    assert not torch.equal(a.weight, c.weight)
    assert (a.bias == 0).all()
    bound = np.sqrt(3.0 / 8)
    assert a.weight.abs().max() <= bound


# ----------------------------- the rest of mxnet_tpu's gluon.nn layers
# Every case is built in both packages with its input width left out
# (deferred) where the layer takes one. The port's own first forward must
# resolve the same name -> shape map as mxnet_tpu's; then mxnet_tpu's
# (random) values are carried over and the forward, the input gradient and
# every parameter gradient of sum(out * head) are compared, within 1e-5 of
# scale (1e-4 where f32 sums reorder: the normalizations and the convs).

def _scaled(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _layer_values(jblk, rng):
    values = {}
    for name, p in jblk.collect_params().items():
        v = rng.randn(*p.shape).astype(np.float32) * 0.5
        if name.endswith("var"):
            v = np.abs(v) + 0.5
        values[name] = v
        p.set_data(mx.nd.array(v))
    return values


def _fwd_bwd(jblk, tblk, x, train=False, tol=TOL, seed=0):
    """Forward and gradients of both blocks on ``x``; returns the port's
    and mxnet_tpu's (outputs, input gradient, {name: param gradient})."""
    rng = np.random.RandomState(seed)
    jblk.initialize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out_shape = jblk(mx.nd.array(x)).shape    # resolves deferred shapes
    tblk.initialize(ctx=mt.cpu())
    with torch.inference_mode():
        tblk(torch.from_numpy(x))
    want_shapes = {k: tuple(p.shape) for k, p in
                   jblk.collect_params().items()}
    got_shapes = {k: tuple(t.shape) for k, t in
                  tblk.collect_params().items()}
    assert got_shapes == want_shapes
    values = _layer_values(jblk, rng)
    tblk.load_numpy_params(values)
    xj = mx.nd.array(x)
    xj.attach_grad()
    head = rng.randn(*out_shape).astype(np.float32)
    with mx.autograd.record(train_mode=train):
        yj = jblk(xj)
        loss = (yj * mx.nd.array(head)).sum()
    loss.backward()
    xt = torch.from_numpy(x.copy()).requires_grad_()
    with mt.autograd.record(train_mode=train):
        yt = tblk(xt)
        (yt * torch.from_numpy(head)).sum().backward()
    _scaled(yt.detach().numpy(), yj.asnumpy(), tol)
    _scaled(xt.grad.numpy(), xj.grad.asnumpy(), tol)
    tparams = tblk._param_objects()
    for name, p in jblk.collect_params().items():
        if p.grad_req == "null":
            assert tparams[name].grad_req == "null", name
            continue
        _scaled(tparams[name].grad().numpy(), p.grad().asnumpy(), tol)
    return yt.detach().numpy()


def _x(*shape, seed=1):
    return (np.random.RandomState(seed).randn(*shape) * 2 + 0.5).astype(
        np.float32)


# name, constructor (lib's nn -> block), input shape, train, tolerance
LAYERS = [
    ("dropout_p0", lambda nn: nn.Dropout(0.0), (2, 3, 4), True, TOL),
    ("dropout_predict", lambda nn: nn.Dropout(0.5), (2, 3, 4), False, TOL),
    ("instance_norm", lambda nn: nn.InstanceNorm(prefix="in_"),
     (2, 3, 5, 4), False, 1e-4),
    ("instance_norm_scale", lambda nn: nn.InstanceNorm(
        scale=True, center=False, prefix="in_"), (2, 4, 5, 3), False, 1e-4),
    ("group_norm", lambda nn: nn.GroupNorm(num_groups=2, prefix="gn_"),
     (2, 4, 3, 3), False, 1e-4),
    ("layer_norm_axis1", lambda nn: nn.LayerNorm(axis=1, prefix="ln_"),
     (2, 5, 3), False, 1e-4),
    ("layer_norm_no_center_scale", lambda nn: nn.LayerNorm(
        center=False, scale=False, prefix="ln_"), (2, 3, 6), False, 1e-4),
    ("batch_norm_deferred_train", lambda nn: nn.BatchNorm(prefix="bn_"),
     (4, 3, 2, 2), True, 1e-4),
    ("batch_norm_axis3_predict", lambda nn: nn.BatchNorm(axis=3,
                                                         prefix="bn_"),
     (2, 2, 2, 5), False, 1e-4),
    ("prelu", lambda nn: _prelu(nn)(prefix="pr_"), (2, 3, 4), False, TOL),
    ("prelu_channels", lambda nn: _prelu(nn)(in_channels=3, prefix="pr_"),
     (2, 3, 4), False, TOL),
    ("elu", lambda nn: nn.ELU(alpha=0.7), (2, 9), False, TOL),
    ("selu", lambda nn: nn.SELU(), (2, 9), False, TOL),
    ("swish", lambda nn: nn.Swish(beta=1.5), (2, 9), False, TOL),
    ("hybrid_lambda_op", lambda nn: nn.HybridLambda("tanh"), (2, 5), False,
     TOL),
    ("hybrid_lambda_fn", lambda nn: nn.HybridLambda(
        lambda F, x: F.relu(x) * 2), (2, 5), False, TOL),
    ("dense_deferred", lambda nn: nn.Dense(4, prefix="d_"), (2, 3, 2),
     False, TOL),
    ("conv1d", lambda nn: nn.Conv1D(4, 3, strides=2, padding=1,
                                    prefix="c_"), (2, 3, 9), False, 1e-4),
    ("conv1d_groups_dilate", lambda nn: nn.Conv1D(
        4, 3, dilation=2, groups=2, activation="relu", prefix="c_"),
     (2, 4, 9), False, 1e-4),
    ("conv3d", lambda nn: nn.Conv3D(3, (2, 3, 1), strides=(1, 2, 1),
                                    padding=(1, 0, 0), prefix="c_"),
     (1, 2, 4, 5, 3), False, 1e-4),
    ("conv1d_transpose", lambda nn: nn.Conv1DTranspose(
        3, 4, strides=2, padding=1, output_padding=1, prefix="ct_"),
     (2, 2, 5), False, 1e-4),
    ("conv2d_transpose_groups", lambda nn: nn.Conv2DTranspose(
        4, 3, strides=2, padding=1, output_padding=1, groups=2,
        prefix="ct_"), (1, 4, 3, 4), False, 1e-4),
    ("conv2d_transpose_dilate", lambda nn: nn.Conv2DTranspose(
        2, (2, 3), strides=(1, 2), dilation=2, use_bias=False,
        prefix="ct_"), (1, 3, 3, 3), False, 1e-4),
    ("conv3d_transpose", lambda nn: nn.Conv3DTranspose(
        2, 2, strides=2, output_padding=(1, 0, 1), prefix="ct_"),
     (1, 3, 2, 3, 2), False, 1e-4),
    ("maxpool1d", lambda nn: nn.MaxPool1D(3, 2, 1), (2, 3, 8), False, TOL),
    ("avgpool1d_ceil", lambda nn: nn.AvgPool1D(3, 2, ceil_mode=True),
     (2, 3, 8), False, TOL),
    ("avgpool1d_no_pad_count", lambda nn: nn.AvgPool1D(
        3, 2, 1, count_include_pad=False), (2, 3, 8), False, TOL),
    ("global_pools_1d", lambda nn: _stack(nn, nn.GlobalMaxPool1D(),
                                          nn.GlobalAvgPool1D()),
     (2, 3, 8), False, TOL),
    ("maxpool3d", lambda nn: nn.MaxPool3D(2, 1, ceil_mode=True),
     (1, 2, 3, 4, 3), False, TOL),
    ("avgpool3d", lambda nn: nn.AvgPool3D((2, 2, 1), padding=(1, 0, 0)),
     (1, 2, 3, 4, 3), False, TOL),
    ("global_pools_3d", lambda nn: _stack(nn, nn.GlobalAvgPool3D(),
                                          nn.GlobalMaxPool3D()),
     (1, 2, 3, 4, 3), False, TOL),
    ("reflection_pad2d", lambda nn: nn.ReflectionPad2D(2), (1, 2, 4, 5),
     False, TOL),
    ("reflection_pad2d_pairs", lambda nn: nn.ReflectionPad2D(
        (0, 0, 0, 0, 1, 2, 0, 3)), (1, 2, 4, 5), False, TOL),
]


class _JaxPReLU(jgluon.nn.PReLU):
    """mxnet_tpu's PReLU passes its slope as ``gamma=``, which its op
    wrapper leaves an NDArray inside the traced function (it raises);
    the same op with the slope given positionally is the reference."""

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu", name="fwd")


def _prelu(nn):
    return _JaxPReLU if nn is jgluon.nn else nn.PReLU


def _stack(nn, *blocks):
    seq = nn.HybridSequential(prefix="s_")
    seq.add(*blocks)
    return seq


@pytest.mark.parametrize("name,make,shape,train,tol", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_new_layer_matches_mxnet_tpu(name, make, shape, train, tol):
    _fwd_bwd(make(jgluon.nn), make(tnn), _x(*shape), train=train, tol=tol)


def test_batch_norm_deferred_running_statistics():
    """A deferred BatchNorm trained one step writes the running
    statistics mxnet_tpu writes."""
    jb, tb = jgluon.nn.BatchNorm(prefix="bn_"), tnn.BatchNorm(prefix="bn_")
    x = _x(6, 3, 2, 2)
    _fwd_bwd(jb, tb, x, train=True, tol=1e-4)
    for name in ("bn_running_mean", "bn_running_var"):
        _scaled(tb.collect_params()[name].numpy(),
                jb.collect_params()[name].data().asnumpy(), 1e-5)


def test_lambda_wraps_a_function_or_an_nd_op():
    t = tnn.Lambda(lambda x: x * 3)
    x = torch.arange(4.0)
    assert torch.equal(t(x), x * 3)
    t = tnn.Lambda("relu")
    with mt.cpu():
        got = t(mt.nd.array(np.array([-1.0, 2.0], np.float32)))
    assert got.asnumpy().tolist() == [0.0, 2.0]
    with pytest.raises(ValueError, match="not found"):
        tnn.Lambda("no_such_op")
    with pytest.raises(ValueError, match="not found"):
        tnn.HybridLambda("no_such_op")


@pytest.mark.parametrize("p,axes", [(0.3, ()), (0.5, (1,)), (0.75, (0, 2))])
def test_dropout_statistics_in_training(p, axes):
    """In training a kept element is scaled by 1 / (1 - p) and about 1 - p
    of them are kept, whole along ``axes``; from the device's generator,
    so a seed repeats the mask."""
    layer = tnn.Dropout(p, axes=axes)
    x = torch.ones(64, 32, 48)

    def run(seed):
        mt.random.seed(seed)
        with mt.autograd.train_mode():
            return layer(x)

    out = run(3)
    kept = out != 0
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / (1 - p)))
    draws = x.numel() // np.prod([x.shape[a] for a in axes], dtype=int)
    assert abs(kept.float().mean().item() - (1 - p)) < \
        4 * np.sqrt(p * (1 - p) / draws)
    for ax in axes:
        assert (kept == kept.narrow(ax, 0, 1)).all()
    assert torch.equal(out, run(3))
    assert not torch.equal(out, run(4))
    with mt.autograd.predict_mode():
        assert torch.equal(layer(x), x)


def test_layers_on_a_symbol_write_mxnet_tpu_nodes():
    """The new layers called on a Symbol build a graph whose forward is
    the layer's own."""
    seq = tnn.HybridSequential(prefix="g_")
    seq.add(tnn.Conv1D(4, 3, in_channels=2), tnn.InstanceNorm(in_channels=4),
            tnn.ELU(0.5), tnn.GlobalAvgPool1D())
    seq.initialize(ctx=mt.cpu(), generator=torch.Generator().manual_seed(0))
    sym = seq(mt.symbol.var("data"))
    x = torch.from_numpy(_x(2, 2, 7))
    args = dict(seq.collect_params(), data=x)
    with mt.cpu():
        ex = sym.bind(mt.cpu(), {k: mt.nd.NDArray(v) for k, v in args.items()
                                 if k in sym.list_arguments()})
        out = ex.forward()[0].asnumpy()
    with torch.inference_mode():
        np.testing.assert_allclose(out, seq(x).numpy(), rtol=0, atol=1e-6)


def test_deferred_parameter_data_raises_until_the_first_forward():
    d = tnn.Dense(3, prefix="q_")
    d.initialize(ctx=mt.cpu())
    with pytest.raises(mt.gluon.DeferredInitializationError,
                       match="deferred"):
        d._reg_params["weight"].data()
    d(torch.ones(2, 5))
    assert d._reg_params["weight"].data().shape == (3, 5)
    e = tnn.Embedding(0, 4)
    e.initialize(ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="input_dim"):
        e(torch.zeros(2, dtype=torch.int64))

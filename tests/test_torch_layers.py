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

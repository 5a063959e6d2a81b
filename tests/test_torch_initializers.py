"""Initializers of the PyTorch port against mxnet_tpu's, on the CPU.

Deterministic initializers (and the name dispatch that sends biases,
gammas, betas and running statistics to constants) are held exactly to
mxnet_tpu's; random ones draw from the torch.Generator given, so they are
held to their distribution's mean and variance, and a seed repeats them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import initializer as tinit  # noqa: E402


def _jax(init, name, shape):
    arr = mx.nd.zeros(shape)
    init(mx.initializer.InitDesc(name), arr)
    return arr.asnumpy()


def _port(init, name, shape, seed=0):
    t = torch.full(shape, 7.0)
    init(name, t, torch.Generator().manual_seed(seed))
    return t.numpy()


DETERMINISTIC = [
    ("zero", lambda m: m.Zero(), "w_weight", (3, 4)),
    ("one", lambda m: m.One(), "w_weight", (3, 4)),
    ("constant", lambda m: m.Constant(0.37), "w_weight", (2, 5)),
    ("constant_array", lambda m: m.Constant([[1.0, 2.0, 3.0]]), "w_weight",
     (2, 3)),
    ("bilinear", lambda m: m.Bilinear(), "up_weight", (2, 1, 4, 4)),
    ("bilinear_odd", lambda m: m.Bilinear(), "up_weight", (1, 2, 3, 5)),
]


@pytest.mark.parametrize("name,make,pname,shape", DETERMINISTIC,
                         ids=[c[0] for c in DETERMINISTIC])
def test_deterministic_initializer_exact(name, make, pname, shape):
    np.testing.assert_array_equal(_port(make(tinit), pname, shape),
                                  _jax(make(mx.initializer), pname, shape))


@pytest.mark.parametrize("pname,n,forget", [("l_i2h_bias", 16, 1.5),
                                            ("l_weight", 8, 1.0)])
def test_lstm_bias(pname, n, forget):
    """Zeros with the forget gate's quarter (gates i, f, g, o) at
    ``forget_bias``, whatever the name. mxnet_tpu's LSTMBias writes into
    the read-only ``asnumpy()`` of its array and raises, so the values are
    its code's intent (``mxnet_tpu/initializer.py:249-255``)."""
    want = np.zeros(n, np.float32)
    want[n // 4:n // 2] = forget
    np.testing.assert_array_equal(
        _port(tinit.LSTMBias(forget_bias=forget), pname, (n,)), want)


@pytest.mark.parametrize("pname", [
    "fc_bias", "bn_gamma", "bn_beta", "q_min", "q_max", "bn_running_mean",
    "bn_running_var", "bn_moving_mean", "bn_moving_var", "x_moving_avg",
    "x_moving_inv_var"])
def test_name_dispatch_exact(pname):
    """Whatever the initializer, these names take mxnet_tpu's constants."""
    for make in (lambda m: m.Uniform(), lambda m: m.Normal(1.0),
                 lambda m: m.Xavier()):
        np.testing.assert_array_equal(_port(make(tinit), pname, (6,)),
                                      _jax(make(mx.initializer), pname,
                                           (6,)))


def _moments(init, shape, name="w_weight", seed=0):
    a = _port(init, name, shape, seed).astype(np.float64)
    return a.mean(), a.var(), a


RANDOM = [
    # constructor, shape, mean, variance
    ("uniform", lambda m: m.Uniform(0.5), (300, 200), 0.0, 0.25 / 3),
    ("normal", lambda m: m.Normal(0.2), (300, 200), 0.0, 0.04),
    ("xavier_uniform_avg", lambda m: m.Xavier(), (100, 200, 3, 1), 0.0,
     3.0 / (0.5 * (600 + 300)) / 3),
    ("xavier_gaussian_in", lambda m: m.Xavier("gaussian", "in", 2),
     (256, 300), 0.0, 2.0 / 300),
    ("xavier_gaussian_out", lambda m: m.Xavier("gaussian", "out", 2),
     (64, 32, 3, 3), 0.0, 2.0 / (64 * 9)),
    ("msra_prelu", lambda m: m.MSRAPrelu("in", 0.5), (256, 400), 0.0,
     2.0 / 1.25 / 400),
]


@pytest.mark.parametrize("name,make,shape,mean,var", RANDOM,
                         ids=[c[0] for c in RANDOM])
def test_random_initializer_moments(name, make, shape, mean, var):
    """Mean and variance of the port's draws are the distribution's (within
    5 standard errors); mxnet_tpu's draws of the same initializer give the
    same moments."""
    got_mean, got_var, a = _moments(make(tinit), shape)
    n = a.size
    assert abs(got_mean - mean) < 5 * np.sqrt(var / n)
    assert abs(got_var / var - 1) < 5 * np.sqrt(2.0 / n) + 0.01
    j = _jax(make(mx.initializer), "w_weight", shape).astype(np.float64)
    assert abs(j.var() / var - 1) < 5 * np.sqrt(2.0 / n) + 0.01
    if "uniform" in name:
        bound = np.sqrt(3 * var)
        assert np.abs(a).max() <= bound + 1e-6


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(6, 10), (10, 3, 2)])
def test_orthogonal(rand_type, shape):
    """scale times an orthonormal factor: rows (or columns) orthonormal
    after dividing by the scale, as mxnet_tpu's."""
    got = _port(tinit.Orthogonal(scale=1.5, rand_type=rand_type), "w_weight",
                shape).reshape(shape[0], -1) / 1.5
    want = _jax(mx.initializer.Orthogonal(scale=1.5, rand_type=rand_type),
                "w_weight", shape).reshape(shape[0], -1) / 1.5
    for m in (got, want):
        small = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        np.testing.assert_allclose(small, np.eye(small.shape[0]),
                                   atol=1e-5)


def test_seed_repeats_and_differs():
    for make in (lambda: tinit.Uniform(), lambda: tinit.Normal(),
                 lambda: tinit.Xavier(), lambda: tinit.Orthogonal()):
        a = _port(make(), "w_weight", (8, 8), seed=1)
        b = _port(make(), "w_weight", (8, 8), seed=1)
        c = _port(make(), "w_weight", (8, 8), seed=2)
        assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_fused_rnn_parameters_take_the_small_uniform():
    a = _port(tinit.Normal(5.0), "lstm0_parameters", (4000,))
    assert np.abs(a).max() <= 0.07 and a.std() > 0.03


def test_mixed_by_pattern():
    mixed = tinit.Mixed([".*_bias", ".*conv.*", ".*"],
                        [tinit.Constant(3.0), "ones", tinit.Zero()])
    jmixed = mx.initializer.Mixed(
        [".*_bias", ".*conv.*", ".*"],
        [mx.initializer.Constant(3.0), mx.initializer.One(),
         mx.initializer.Zero()])
    for name in ("fc_bias", "conv1_weight", "fc_weight"):
        np.testing.assert_array_equal(_port(mixed, name, (3,)),
                                      _jax(jmixed, name, (3,)))
    with pytest.raises(mt.MXNetError, match="did not match"):
        _port(tinit.Mixed(["conv"], ["zeros"]), "fc_weight", (2,))


def test_load_from_dict_and_file(tmp_path):
    values = {"arg:fc_weight": np.arange(6, dtype=np.float32).reshape(2, 3),
              "aux:bn_running_mean": np.ones(3, np.float32)}
    load = tinit.Load(values, default_init=tinit.Constant(9.0))
    np.testing.assert_array_equal(_port(load, "fc_weight", (2, 3)),
                                  values["arg:fc_weight"])
    np.testing.assert_array_equal(_port(load, "bn_running_mean", (3,)),
                                  np.ones(3))
    np.testing.assert_array_equal(_port(load, "other_weight", (2,)),
                                  np.full(2, 9.0))
    with pytest.raises(mt.MXNetError, match="not found"):
        _port(tinit.Load(values), "other_weight", (2,))
    with pytest.raises(mt.MXNetError, match="shape"):
        _port(load, "fc_weight", (3, 2))
    path = str(tmp_path / "w.params")
    mx.nd.save(path, {k: mx.nd.array(v) for k, v in values.items()})
    np.testing.assert_array_equal(
        _port(tinit.Load(path), "fc_weight", (2, 3)), values["arg:fc_weight"])


def test_init_desc_register_create():
    desc = tinit.InitDesc("fc_weight", attrs={"lr_mult": "2"},
                          global_init=tinit.One())
    assert desc == "fc_weight" and isinstance(desc, str)
    assert desc.attrs == {"lr_mult": "2"} and isinstance(desc.global_init,
                                                         tinit.One)
    np.testing.assert_array_equal(_port(tinit.One(), desc, (2,)), np.ones(2))
    for name, klass in (("normal", tinit.Normal), ("zeros", tinit.Zero),
                        ("ones", tinit.One), ("xavier", tinit.Xavier),
                        ("Xavier", tinit.Xavier), ("msraprelu",
                                                   tinit.MSRAPrelu),
                        ("orthogonal", tinit.Orthogonal),
                        ("bilinear", tinit.Bilinear),
                        ("lstmbias", tinit.LSTMBias),
                        ("constant", tinit.Constant),
                        ("uniform", tinit.Uniform)):
        assert type(tinit.create(name)) is klass
    assert tinit.create("normal", sigma=0.5).sigma == 0.5
    with pytest.raises(mt.MXNetError, match="cannot create"):
        tinit.create("no_such_init")

    @tinit.register
    class Twos(tinit.Initializer):
        def _init_weight(self, _, arr, generator):
            arr.fill_(2.0)

    assert type(tinit.create("twos")) is Twos
    blk = mt.gluon.nn.Dense(3, in_units=2, prefix="r_",
                            weight_initializer="twos")
    blk.initialize(ctx=mt.cpu())
    assert (blk.weight == 2).all()
    assert tinit.Normal(0.3).dumps() == \
        mx.initializer.Normal(0.3).dumps()


def test_normal_by_name_through_a_layer():
    """``weight_initializer="normal"`` (VGG's Dense layers) is N(0, 0.01),
    from the generator given to initialize."""
    blk = mt.gluon.nn.Dense(300, in_units=400, prefix="n_",
                            weight_initializer="normal")
    blk.initialize(ctx=mt.cpu(), generator=torch.Generator().manual_seed(0))
    w = blk.weight.detach().double()
    assert abs(w.std().item() / 0.01 - 1) < 0.01
    assert (blk.bias == 0).all()

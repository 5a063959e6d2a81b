"""The samplers of ``mxnet_tpu/ops/random_ops.py`` and ``mx.random``,
held to their statistics: a torch generator cannot repeat JAX's bits, so
each sampler's mean and variance over N draws lie within 5 standard
errors of the distribution's, on both packages (N = 100,000 here; the
card runs 1,000,000). ``mx.random.seed`` repeats a draw bitwise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402

N = 100_000

# name -> (params, mean, variance) of a scalar-parameter sampler
SAMPLERS = {
    "_random_uniform": ({"low": -1.0, "high": 3.0}, 1.0, 16.0 / 12),
    "_random_normal": ({"loc": 1.0, "scale": 2.0}, 1.0, 4.0),
    "_random_gamma": ({"alpha": 2.5, "beta": 0.5}, 1.25, 0.625),
    "_random_exponential": ({"lam": 2.0}, 0.5, 0.25),
    "_random_poisson": ({"lam": 3.0}, 3.0, 3.0),
    "_random_negative_binomial": ({"k_param": 3, "p": 0.4}, 4.5, 11.25),
    "_random_generalized_negative_binomial": ({"mu": 2.0, "alpha": 0.5},
                                              2.0, 4.0),
    "_random_randint": ({"low": 0, "high": 10}, 4.5, 8.25),
    "_random_bernoulli": ({"p": 0.3}, 0.3, 0.21),
    # array-parameter samplers, the second row of their parameters
    "_sample_uniform": (None, 2.0, 4.0 / 12),
    "_sample_normal": (None, -1.0, 0.25),
    "_sample_gamma": (None, 3.0, 3.0),
    "_sample_multinomial": (None, 1.3, 0.61),
    "_shuffle": (None, None, None),
}
_ARRAY_PARAMS = {
    "_sample_uniform": ([0.0, 1.0], [1.0, 3.0]),
    "_sample_normal": ([0.0, -1.0], [1.0, 0.5]),
    "_sample_gamma": ([1.0, 3.0], [1.0, 1.0]),
}


def _draws(lib, name):
    with lib.cpu():
        nd = lib.nd
        if name in _ARRAY_PARAMS:
            a, b = (nd.array(np.array(v, np.float32))
                    for v in _ARRAY_PARAMS[name])
            return getattr(nd, name)(a, b, shape=(N,)).asnumpy()[1]
        if name == "_sample_multinomial":
            probs = nd.array(np.array([0.2, 0.3, 0.5], np.float32))
            return getattr(nd, name)(probs, shape=(N,)).asnumpy()
        params = dict(SAMPLERS[name][0])
        if lib is mx and name == "_random_negative_binomial":
            params = {"k_param": params["k_param"], "p": params["p"]}
        return getattr(nd, name)(shape=(N,), **params).asnumpy()


def _within_5_se(x, mean, var, what):
    x = x.astype(np.float64)
    m, v = x.mean(), x.var()
    mu4 = ((x - m) ** 4).mean()
    se_m, se_v = np.sqrt(var / len(x)), np.sqrt(max(mu4 - v * v, 0) / len(x))
    assert abs(m - mean) < 5 * se_m, (what, m, mean, se_m)
    assert abs(v - var) < 5 * se_v, (what, v, var, se_v)


# mxnet_tpu's multinomial sampler cannot run eagerly (its draw count is
# traced under its op jit), so only the port is held there
_PORT_ONLY = ("_sample_multinomial",)


@pytest.mark.parametrize("name", [n for n, s in SAMPLERS.items()
                                  if s[1] is not None])
def test_sampler_statistics_on_both_packages(name):
    _, mean, var = SAMPLERS[name]
    for lib in (mt,) if name in _PORT_ONLY else (mx, mt):
        _within_5_se(_draws(lib, name), mean, var, f"{lib.__name__} {name}")


def test_shuffle_is_a_permutation():
    with mt.cpu():
        x = mt.nd.arange(0, 1000)
        y = mt.nd._shuffle(x).asnumpy()
    assert sorted(y.tolist()) == list(range(1000))
    assert (y != np.arange(1000)).any()


def test_seed_repeats_every_draw_bitwise():
    with mt.cpu():
        draws = []
        for _ in range(2):
            mt.random.seed(0)
            draws.append([mt.random.uniform(shape=(64,)).asnumpy(),
                          mt.random.normal(shape=(64,)).asnumpy(),
                          mt.random.gamma(2.0, shape=(64,)).asnumpy(),
                          mt.random.randint(0, 9, shape=(64,)).asnumpy(),
                          mt.nd.Dropout(mt.nd.ones((64,)), p=0.5,
                                        mode="always").asnumpy()])
        for a, b in zip(*draws):
            np.testing.assert_array_equal(a, b)
        mt.random.seed(1)
        assert not np.array_equal(mt.random.uniform(shape=(64,)).asnumpy(),
                                  draws[0][0])


def test_random_frontend_functions():
    with mt.cpu():
        mt.random.seed(3)
        assert mt.random.randn(2, 3).shape == (2, 3)
        assert mt.random.exponential(2.0, shape=(5,)).shape == (5,)
        assert mt.random.poisson(2.0, shape=(5,)).shape == (5,)
        b = mt.random.bernoulli(0.5, shape=(100,)).asnumpy()
        assert set(np.unique(b)) <= {0.0, 1.0}
        lo = mt.nd.array([0.0, 10.0])
        s = mt.random.uniform(lo, lo + 1, shape=(50,)).asnumpy()
        assert s.shape == (2, 50) and (s[1] >= 10).all() and (s[1] < 11).all()
        out = mt.nd.zeros((4,))
        mt.random.normal(shape=(4,), out=out)
        assert (out.asnumpy() != 0).all()
        m = mt.random.multinomial(mt.nd.array([[0.0, 1.0], [1.0, 0.0]]),
                                  shape=(3,)).asnumpy()
        np.testing.assert_array_equal(m, [[1, 1, 1], [0, 0, 0]])


def test_dropout_training_statistics():
    """Dropout in training keeps 1 - p of the elements, scaled by 1 / (1 -
    p), on both packages; outside training it is the identity."""
    for lib in (mx, mt):
        with lib.cpu():
            x = lib.nd.ones((N,))
            with lib.autograd.train_mode():
                y = lib.nd.Dropout(x, p=0.25).asnumpy()
            kept = y != 0
            np.testing.assert_allclose(y[kept], 1 / 0.75, rtol=1e-6)
            _within_5_se(kept.astype(np.float64), 0.75, 0.75 * 0.25,
                         lib.__name__)
            np.testing.assert_array_equal(
                lib.nd.Dropout(x, p=0.25).asnumpy(), np.ones(N))


def test_gluon_F_draws_from_the_seeded_generator_on_the_context():
    """A HybridBlock's ``F`` runs Dropout and the samplers on
    ``mx.random``'s generator, so ``mx.random.seed`` repeats them whatever
    torch's global stream does, and its creation ops make their tensors on
    the current context."""

    class Net(mt.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.Dropout(x, p=0.5) + F._random_normal(shape=(64,)) \
                + F._zeros(shape=(64,))

    net = Net()
    with mt.cpu():
        runs = []
        for torch_seed in (0, 1):
            mt.random.seed(7)
            torch.manual_seed(torch_seed)
            with mt.autograd.train_mode():
                runs.append(net(torch.ones(64)).numpy())
        np.testing.assert_array_equal(runs[0], runs[1])
        assert mt.gluon.block.F_TENSOR._zeros(shape=(2,)).device == \
            mt.cpu().torch_device()

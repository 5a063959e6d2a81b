"""ResNet training in the port's eager path against ``mxnet_tpu``'s, on the
CPU: BatchNorm's training forward and gradients, and ``gluon.Trainer`` with
SGD momentum on the narrow ResNet-50 v1 of ``test_torch_vision.py``.

BatchNorm in training normalises with single-pass f32 moments
(E[x^2] - E[x]^2, clamped at 0), updates the running statistics by an EMA
and differentiates through the moments; its output, new running
statistics and the gradients of data, gamma and beta are held to
``jax.grad`` of ``mxnet_tpu/ops/nn.py:_batch_norm`` within 1e-5 of their
scale (f32 sums in other orders, amplified by the moments' cancellation
for channels whose mean is large beside their spread).

The eager step is ``autograd.record()`` -> ``SoftmaxCrossEntropyLoss`` ->
``backward()`` -> ``Trainer.step`` (SGD, lr 0.1, momentum 0.9, wd 1e-4),
3 steps on 8 zero-mean images of 64x64, each step from ``mxnet_tpu``'s
weights and momentum (copied into the port before it; ``test_torch_parallel``
says why this net's f32 runs do not stay together when chained): the loss
within 1e-5 relative, every gradient, weight, running statistic and
momentum within 1e-4 of its scale (max(1, max|ref|)).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.ops import nn as jops  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.ops import nn as tops  # noqa: E402

from test_torch_parallel import (LAYOUTS, OPT, STATE_TOL,  # noqa: E402
                                 _batch, _close, _np, _pair)

BN_TOL = 1e-5


def _bn_inputs(axis, mean, seed=0):
    rng = np.random.RandomState(seed)
    shape = (8, 16, 6, 6) if axis == 1 else (8, 6, 6, 16)
    c = shape[axis]
    x = (rng.randn(*shape) * 1.5 + mean).astype(np.float32)
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    beta = (rng.randn(c) * 0.1).astype(np.float32)
    mm = (rng.randn(c) * 0.1).astype(np.float32)
    mv = (rng.rand(c) + 0.5).astype(np.float32)
    dout = rng.randn(*shape).astype(np.float32)
    return x, gamma, beta, mm, mv, dout


@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("mean", [0.0, 2.0])
@pytest.mark.parametrize("axis", [1, 3])
def test_batch_norm_training_matches_jax_grad(axis, mean, fix_gamma):
    x, gamma, beta, mm, mv, dout = _bn_inputs(axis, mean)
    kw = dict(eps=1e-5, momentum=0.9, fix_gamma=fix_gamma, axis=axis,
              _train=True)

    def jloss(x, gamma, beta):
        out, nm, nv = jops._batch_norm(x, gamma, beta, jnp.asarray(mm),
                                       jnp.asarray(mv), **kw)
        return jnp.sum(out * dout), (out, nm, nv)

    (_, (jout, jnm, jnv)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(x, gamma, beta)
    tx, tg, tb = (torch.tensor(a, requires_grad=True)
                  for a in (x, gamma, beta))
    out, nm, nv = tops.batch_norm(tx, tg, tb, torch.tensor(mm),
                                  torch.tensor(mv), **kw)
    (out * torch.from_numpy(dout)).sum().backward()
    _close(out, jout, BN_TOL, "out")
    _close(nm, jnm, BN_TOL, "new running mean")
    _close(nv, jnv, BN_TOL, "new running var")
    _close(tx.grad, jgrads[0], BN_TOL, "d data")
    _close(tb.grad, jgrads[2], BN_TOL, "d beta")
    if fix_gamma:          # gamma is not read: its gradient is zero
        assert tg.grad is None
        assert not np.asarray(jgrads[1]).any()
    else:
        _close(tg.grad, jgrads[1], BN_TOL, "d gamma")


@pytest.mark.parametrize("axis", [1, 3])
def test_batchnorm_layer_writes_running_stats_only_in_training(axis):
    """The Block: inside record() it returns the batch-normalised output
    and writes the EMA into running_mean / running_var in place, as
    mxnet_tpu's does; under predict mode it reads them and writes
    nothing."""
    x, gamma, beta, mm, mv, _ = _bn_inputs(axis, 1.0, seed=1)
    c = gamma.shape[0]
    jb = mx.gluon.nn.BatchNorm(axis=axis, in_channels=c, prefix="bn_")
    jb.initialize()
    tb = mt.gluon.nn.BatchNorm(axis=axis, in_channels=c, prefix="bn_")
    tb.initialize(ctx=mt.cpu())
    values = {"gamma": gamma, "beta": beta, "running_mean": mm,
              "running_var": mv}
    for name, p in jb.collect_params().items():
        p.set_data(mx.nd.array(values[name.split("_", 1)[1]]))
    tb.load_numpy_params({k: values[k.split("_", 1)[1]]
                          for k in tb.collect_params()})
    with mx.autograd.record():
        jout = jb(mx.nd.array(x))
    with mt.autograd.record():
        tout = tb(torch.from_numpy(x))
    _close(tout, jout.asnumpy(), BN_TOL, "train out")
    jp = jb.collect_params()
    for name, t in tb.collect_params().items():
        _close(t, jp[name].data().asnumpy(), BN_TOL, name)
    assert not np.array_equal(tb.running_mean.numpy(), mm)
    before = tb.running_mean.clone()
    with mt.autograd.predict_mode():
        tb(torch.from_numpy(x))
    assert torch.equal(tb.running_mean, before)


def _load_jax_state(tnet, ttrainer, jnet, jtrainer):
    """mxnet_tpu's weights, running statistics and momentum into the
    port's net and Trainer."""
    tnet.load_numpy_params({k: p.data().asnumpy()
                            for k, p in jnet.collect_params().items()})
    jstates = jtrainer._updaters[0].states
    with torch.no_grad():
        for i, mom in jstates.items():
            ttrainer._updater.states[i].copy_(torch.tensor(mom.asnumpy()))


def _eager_step(pkg, net, trainer, x, y):
    lib = mx if pkg == "jax" else mt
    loss_fn = lib.gluon.loss.SoftmaxCrossEntropyLoss()
    if pkg == "jax":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with mx.autograd.record():
                loss = loss_fn(net(mx.nd.array(x)), mx.nd.array(y)).mean()
            loss.backward()
        grads = {k: p.grad().asnumpy()
                 for k, p in net.collect_params().items()
                 if p.grad_req != "null"}
        trainer.step(1)
        return float(loss.asnumpy()), grads
    with mt.autograd.record():
        loss = loss_fn(net(torch.from_numpy(x)), torch.from_numpy(y)).mean()
    loss.backward()
    grads = {k: _np(p.grad()) for k, p in net._param_objects().items()
             if p.grad_req != "null"}
    trainer.step(1)
    return loss.item(), grads


@pytest.mark.parametrize("layout,stem", LAYOUTS)
def test_three_eager_sgd_momentum_steps_match_jax(layout, stem):
    jnet, tnet, _ = _pair(layout, stem)
    x, y = _batch()
    jtrainer = mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(OPT))
    ttrainer = mt.gluon.Trainer(tnet.collect_params(), "sgd", dict(OPT))
    for step in range(3):
        if step:
            _load_jax_state(tnet, ttrainer, jnet, jtrainer)
        want, jgrads = _eager_step("jax", jnet, jtrainer, x, y)
        got, tgrads = _eager_step("torch", tnet, ttrainer, x, y)
        assert abs(got - want) <= 1e-5 * abs(want), (step, got, want)
        assert set(tgrads) == set(jgrads)
        for k in jgrads:
            _close(tgrads[k], jgrads[k], STATE_TOL, k + " grad")
        jp = jnet.collect_params()
        for k, t in tnet.collect_params().items():
            _close(t, jp[k].data().asnumpy(), STATE_TOL, k)
        jstates = jtrainer._updaters[0].states
        for i, mom in ttrainer._updater.states.items():
            _close(mom, jstates[i].asnumpy(), STATE_TOL, f"momentum {i}")
    assert len(ttrainer._updater.states) == len(jtrainer._updaters[0].states)


def test_both_trainers_decay_gamma_beta_and_bias_as_mxnet_tpu():
    """mxnet_tpu's gluon.Trainer hands its optimizer each Parameter as
    param_dict, whose wd_mult (1.0 unless set) is all it reads: gamma,
    beta and biases are decayed as the weights are, in the eager path as in
    ShardedTrainer. The zero default for *_bias / *_gamma / *_beta names
    applies only to an optimizer built from param_idx2name. The port
    follows both rules."""
    lr, wd = 0.1, 0.5
    for lib in (mx, mt):
        net = lib.gluon.nn.BatchNorm(in_channels=4, prefix="bn_")
        if lib is mx:
            net.initialize()
        else:
            net.initialize(ctx=mt.cpu())
        trainer = lib.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": lr, "wd": wd})
        ones = np.ones((2, 4), np.float32)
        if lib is mx:
            with mx.autograd.record():
                out = net(mx.nd.array(ones))
            out.backward(mx.nd.zeros((2, 4)))
        else:
            with mt.autograd.record():
                out = net(torch.from_numpy(ones))
            out.backward(torch.zeros(2, 4))
        trainer.step(1)
        gamma = _np(net.collect_params()["bn_gamma"]) if lib is mt else \
            net.collect_params()["bn_gamma"].data().asnumpy()
        # zero gradient: gamma moves by wd alone, 1 - lr * wd
        np.testing.assert_allclose(gamma, 1 - lr * wd, rtol=1e-6)
        named = lib.optimizer.create("sgd", learning_rate=lr, wd=wd,
                                     param_idx2name={0: "bn_gamma",
                                                     1: "conv_weight"})
        assert named._get_wd(0) == 0.0 and named._get_wd(1) == wd

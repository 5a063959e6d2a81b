"""The port's ``lr_scheduler`` and ``metric`` against ``mxnet_tpu``'s.

Schedulers are plain Python on both sides: their rates over updates
0..N agree to the last bit, except where ``mxnet_tpu`` leaves MXNet
(``warmup_mode="constant"``, below). Metrics take the same predictions and
labels, the port's as tensors, and agree within 1e-6 relative (sums of
float32 values read back to the host).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import lr_scheduler as jsched, metric as jmetric  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import lr_scheduler as tsched  # noqa: E402
from mxnet_tpu_torch import metric as tmetric  # noqa: E402

N_UPDATES = 60

SCHEDULERS = [
    ("FactorScheduler", dict(step=7, factor=0.5, stop_factor_lr=1e-3,
                             base_lr=0.4)),
    ("FactorScheduler", dict(step=5, factor=0.9, base_lr=0.1,
                             warmup_steps=10, warmup_begin_lr=0.01)),
    ("MultiFactorScheduler", dict(step=[10, 25, 40], factor=0.1,
                                  base_lr=0.1)),
    ("MultiFactorScheduler", dict(step=[20, 30], factor=0.5, base_lr=0.2,
                                  warmup_steps=8)),
    ("PolyScheduler", dict(max_update=50, base_lr=0.1, pwr=2,
                           final_lr=1e-3)),
    ("PolyScheduler", dict(max_update=50, base_lr=0.1, pwr=1,
                           warmup_steps=5, warmup_begin_lr=0.02)),
    ("CosineScheduler", dict(max_update=45, base_lr=0.1, final_lr=1e-4)),
    ("CosineScheduler", dict(max_update=45, base_lr=0.1, warmup_steps=10,
                             warmup_begin_lr=0.0)),
]


@pytest.mark.parametrize("name,kw", SCHEDULERS,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(SCHEDULERS)])
def test_scheduler_rates_match_jax(name, kw):
    jfn = getattr(jsched, name)(**kw)
    tfn = getattr(tsched, name)(**kw)
    want = [jfn(i) for i in range(N_UPDATES + 1)]
    got = [tfn(i) for i in range(N_UPDATES + 1)]
    assert got == want
    assert len(set(got)) > 2      # the rate really moves


def test_constant_warmup_follows_mxnet():
    """MXNet's constant warm-up holds warmup_begin_lr; mxnet_tpu ramps
    quadratically for every mode but 'linear' (ROADMAP Queue 3). After
    the warm-up both give the schedule's rate."""
    kw = dict(step=[30], factor=0.5, base_lr=0.1, warmup_steps=10,
              warmup_begin_lr=0.01, warmup_mode="constant")
    tfn = tsched.MultiFactorScheduler(**kw)
    jfn = jsched.MultiFactorScheduler(**kw)
    assert [tfn(i) for i in range(10)] == [0.01] * 10
    assert jfn(5) != 0.01                   # the reference's deviation
    assert [tfn(i) for i in range(10, 40)] == [jfn(i)
                                               for i in range(10, 40)]
    with pytest.raises(ValueError, match="warmup_mode"):
        tsched.CosineScheduler(max_update=10, warmup_mode="quadratic")


def _scheduled_run(lib, ctx_kw, to_input):
    """Four SGD steps of a Dense layer through Trainer(lr_scheduler=...);
    returns the rate before each step and the final weight."""
    net = lib.gluon.nn.Dense(3, in_units=4, prefix="d_")
    net.initialize(lib.init.One(), **ctx_kw)
    sched = lib.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    trainer = lib.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.2,
                                 "lr_scheduler": sched})
    x = np.arange(8, dtype=np.float32).reshape(2, 4) / 8
    rates = []
    for _ in range(4):
        rates.append(trainer.learning_rate)
        with lib.autograd.record():
            out = net(to_input(x))
            loss = (out * out).sum()
        loss.backward()
        trainer.step(2)
    return rates, net.collect_params()


def test_optimizer_lr_scheduler_through_trainer():
    want_rates, jparams = _scheduled_run(mx, {}, mx.nd.array)
    got_rates, tparams = _scheduled_run(mt, {"ctx": mt.cpu()},
                                        torch.from_numpy)
    assert got_rates == want_rates == [0.2, 0.2, 0.2, 0.1]
    for name, t in tparams.items():
        np.testing.assert_allclose(t.detach().numpy(),
                                   jparams[name].data().asnumpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def _preds(seed=0, n=32, classes=10):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, classes).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    labels = rng.randint(0, classes, n).astype(np.float32)
    return probs.astype(np.float32), labels


METRICS = [("acc", {}), ("top_k_acc", {"top_k": 3}),
           ("TopKAccuracy", {"top_k": 5}), ("ce", {}),
           ("CrossEntropy", {"eps": 1e-8}), ("accuracy", {}), ("loss", {})]


@pytest.mark.parametrize("name,kw", METRICS,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(METRICS)])
def test_metric_matches_jax(name, kw):
    jm, tm = jmetric.create(name, **kw), tmetric.create(name, **kw)
    assert tm.name == jm.name
    for seed in range(3):
        probs, labels = _preds(seed)
        tp = torch.from_numpy(probs)
        if seed == 2:            # a bf16 tensor, given alone, not listed
            tp = tp.to(torch.bfloat16)
            probs = tp.float().numpy()
            tm.update(torch.from_numpy(labels), tp)
        else:
            tm.update([torch.from_numpy(labels)], [tp])
        jm.update([mx.nd.array(labels)], [mx.nd.array(probs)])
        if seed == 0:
            jm.reset_local()
            tm.reset_local()
    for got, want in ((tm.get(), jm.get()),
                      (tm.get_global(), jm.get_global())):
        assert got[0] == want[0]
        assert math.isclose(got[1], want[1], rel_tol=1e-6), (got, want)
    assert tm.get_name_value()[0][0] == jm.get_name_value()[0][0]


def test_composite_metric_matches_jax():
    probs, labels = _preds(4)
    jm = jmetric.create(["acc", "ce"])
    tm = tmetric.create(["acc", "ce"])
    jm.update([mx.nd.array(labels)], [mx.nd.array(probs)])
    tm.update([torch.from_numpy(labels)], [torch.from_numpy(probs)])
    (jn, jv), (tn, tv) = jm.get(), tm.get()
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=1e-6)
    assert isinstance(tm.get_metric(0), tmetric.Accuracy)


def test_metric_registry_and_unported_names():
    assert isinstance(tmetric.create(tmetric.Loss()), tmetric.Loss)

    @tmetric.register
    class Half(tmetric.EvalMetric):
        def __init__(self):
            super().__init__("half")

        def update(self, labels, preds):
            self._update(0.5, 1)

    m = tmetric.create("half")
    m.update(None, None)
    assert m.get() == ("half", 0.5)
    with pytest.raises(mt.MXNetError, match="not registered"):
        tmetric.create("bleu")
    custom = tmetric.create(lambda label, pred: 0.25)
    assert isinstance(custom, tmetric.CustomMetric)
    custom.update([np.zeros(2)], [np.zeros(2)])
    assert custom.get() == ("custom(<lambda>)", 0.25)

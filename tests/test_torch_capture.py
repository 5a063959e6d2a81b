"""Whole-step capture of the PyTorch port (``mxnet_tpu_torch/capture.py``),
on the CPU, mirroring ``tests/test_capture.py``.

On a CPU context a captured program runs directly, with no CUDA graph, but
through the same static buffers, scalar slots, keys and counters as on the
card: these tests hold the captured gluon step of a 2-layer fp32
``TransformerLM(impl='flash')`` bitwise to the port's eager bulk step (SGD
with momentum; Adam, whose bias correction moves its rate every step), to
``mxnet_tpu``'s eager step within ``tests/test_torch_training.py``'s
tolerances (1e-5), the captured ``ShardedTrainer`` step of a narrow NHWC
ResNet bitwise to its kill-switch eager step, and the captured
``Predictor`` buckets bitwise to eager. ``mxnet_tpu``'s captured step is
not the oracle: its own test fails in this container (ROADMAP Queue 3).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.gluon.model_zoo import transformer as jzoo  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import capture, parallel as tpar, serving  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import transformer as tzoo  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision  # noqa: E402
from _torch_isolation import no_stale_preemption  # noqa: E402,F401

CFG = dict(vocab=64, units=32, num_heads=2, num_layers=2, max_len=64)
B, T = 4, 16
CASES = [("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
         ("adam", {"learning_rate": 1e-3})]


def _loss_fn(out, y):
    return mt.gluon.loss.SoftmaxCrossEntropyLoss()(out, y).mean()


def _values(seed=0):
    """Random LM weights as numpy, keyed by MXNet name."""
    net = tzoo.transformer_lm(impl="flash", prefix="tlm_", **CFG)
    net.initialize(mt.init.Xavier(), ctx=mt.cpu(),
                   generator=torch.Generator().manual_seed(seed))
    return {k: v.detach().numpy().copy()
            for k, v in net.collect_params().items()}


def _lm(values, opt, opt_params):
    net = tzoo.transformer_lm(impl="flash", prefix="tlm_", **CFG)
    net.initialize(ctx=mt.cpu())
    net.load_numpy_params(values)
    return net, mt.gluon.Trainer(net.collect_params(), opt, dict(opt_params))


def _batch(k, b=B):
    rng = np.random.RandomState(100 + k)
    seq = np.zeros((b, T + 1), np.int64)
    seq[:, 0] = rng.randint(0, CFG["vocab"], b)
    for t in range(T):
        seq[:, t + 1] = (5 * seq[:, t] + 3) % CFG["vocab"]
    return torch.from_numpy(seq[:, :-1]), torch.from_numpy(seq[:, 1:])


def _eager_step(net, trainer, x, y):
    with mt.autograd.record():
        loss = _loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss.detach()


def _eager_run(values, opt, opt_params, steps):
    net, trainer = _lm(values, opt, opt_params)
    losses = [_eager_step(net, trainer, *_batch(k)) for k in range(steps)]
    return net, trainer, losses


def _assert_same_state(net_a, tr_a, net_b, tr_b):
    for (name, a), b in zip(net_a.collect_params().items(),
                            net_b.collect_params().values()):
        assert torch.equal(a, b), name
    sa, sb = tr_a._updater.states, tr_b._updater.states
    assert sorted(sa) == sorted(sb)
    for i in sa:
        for a, b in zip(capture._leaves(sa[i]), capture._leaves(sb[i])):
            assert torch.equal(a, b), i
    assert tr_a.optimizer._index_update_count == \
        tr_b.optimizer._index_update_count


@pytest.fixture(autouse=True)
def _fresh_capture_state(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_TORCH_CAPTURE", raising=False)
    monkeypatch.delenv("MXNET_TPU_TORCH_COMPILE_CACHE", raising=False)
    capture.reset_stats()
    capture.clear_retrace_log()
    yield
    capture.reset_stats()
    capture.clear_retrace_log()


# ------------------------------------------------- the gluon step, bitwise
@pytest.mark.parametrize("opt,opt_params", CASES, ids=["sgd", "adam"])
def test_captured_step_bitwise_vs_eager_bulk(opt, opt_params):
    values = _values()
    ref_net, ref_tr, ref_losses = _eager_run(values, opt, opt_params, 5)

    net, trainer = _lm(values, opt, opt_params)
    step = capture.capture(trainer, net=net, loss_fn=_loss_fn)
    losses = [step(*_batch(k), batch_size=B) for k in range(5)]
    _assert_same_state(ref_net, ref_tr, net, trainer)
    for a, b in zip(ref_losses, losses):
        assert torch.equal(a, b)
    s = capture.stats()
    assert s["capture_steps"] == 5
    assert s["capture_misses"] == 1 and s["capture_hits"] == 4
    assert s["capture_retraces"] == 0 and s["capture_fallback_eager"] == 0


def test_captured_step_matches_mxnet_tpu_eager():
    """Three captured Adam steps against mxnet_tpu's eager autograd.record
    / backward / Trainer.step from the same weights: the loss at each step
    within 1e-5 relative, the weights after step 3 within 1e-5, leaving out
    the elements whose step-1 gradient is float noise (below 1e-6, where
    Adam's lr * g / (|g| + 1e-8) turns rounding into +-lr steps; as
    tests/test_torch_training.py), and the step-1 gradients, read through
    param.grad() after the captured step, within 1e-5."""
    values = _values(seed=3)
    jnet = jzoo.transformer_lm(impl="flash", prefix="tlm_", **CFG)
    jnet.initialize(mx.init.Zero())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jnet(mx.nd.array(np.zeros((1, 4)), dtype="int32"))  # deferred init
    for name, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(values[name]))
    opt = {"learning_rate": 1e-3}
    jtr = mx.gluon.Trainer(jnet.collect_params(), "adam", dict(opt))
    jloss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    net, trainer = _lm(values, "adam", opt)
    step = capture.capture(trainer, net=net, loss_fn=_loss_fn)
    jparams = jnet.collect_params()
    noisy = {}
    for k in range(3):
        x, y = _batch(k)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with mx.autograd.record():
                jloss = jloss_fn(jnet(mx.nd.array(x.numpy(), dtype="int32")),
                                 mx.nd.array(y.numpy(), dtype="int32")).mean()
            jloss.backward()
        got, want = step(x, y, batch_size=B).item(), float(jloss.asnumpy())
        assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)
        if k == 0:   # gradients exactly 0 on both sides stay in the check
            for n, p in net._param_objects().items():
                g, w = p.grad().numpy(), jparams[n].grad().asnumpy()
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
                noisy[n] = (np.abs(w) < 1e-6) & ~((w == 0) & (g == 0))
        jtr.step(B)
    n_noisy = sum(int(m.sum()) for m in noisy.values())
    assert n_noisy < 0.02 * sum(m.size for m in noisy.values())
    for name, p in net._param_objects().items():
        keep = ~noisy[name]
        np.testing.assert_allclose(p.data().detach().numpy()[keep],
                                   jparams[name].data().asnumpy()[keep],
                                   rtol=0, atol=1e-5, err_msg=name)


def test_kill_switch_runs_eager_counted(monkeypatch):
    values = _values()
    ref_net, ref_tr, _ = _eager_run(values, "adam", {"learning_rate": 1e-3},
                                    3)
    monkeypatch.setenv("MXNET_TPU_TORCH_CAPTURE", "0")
    assert not capture.enabled()
    net, trainer = _lm(values, "adam", {"learning_rate": 1e-3})
    step = capture.capture(trainer, net=net, loss_fn=_loss_fn)
    for k in range(3):
        step(*_batch(k), batch_size=B)
    _assert_same_state(ref_net, ref_tr, net, trainer)
    s = capture.stats()
    assert s["capture_fallback_eager"] == 3 and s["capture_misses"] == 0


def test_half_batch_retraces_with_a_reason():
    net, trainer = _lm(_values(), "adam", {"learning_rate": 1e-3})
    step = capture.capture(trainer, net=net, loss_fn=_loss_fn)
    x, y = _batch(0)
    step(x, y, batch_size=B)
    assert capture.stats()["capture_retraces"] == 0
    step(x[:B // 2], y[:B // 2], batch_size=B // 2)
    s = capture.stats()
    assert s["capture_retraces"] == 1 and s["capture_misses"] == 2
    log = capture.retrace_log()
    assert len(log) == 1 and log[0]["label"] == "trainer_step"
    assert "changed" in log[0]["reason"]
    assert set(log[0]) == {"label", "reason", "prev", "new", "t"}


def test_rebound_parameter_is_captured_again():
    """A parameter given new memory (Parameter._set, as initialize and cast
    do) changes the step's key: the step is captured again, logged with the
    reason 'rebound state', and computes from the new tensor, as eager."""
    values = _values()
    opt = {"learning_rate": 0.1, "momentum": 0.9}

    def rebind(net):
        p = net._param_objects()["tlm_head_weight"]
        p._set(p.data().detach().clone() * 0.5)

    ref_net, ref_tr = _lm(values, "sgd", opt)
    net, trainer = _lm(values, "sgd", opt)
    step = capture.capture(trainer, net=net, loss_fn=_loss_fn)
    for k in range(3):
        if k == 1:
            rebind(ref_net)
            rebind(net)
        x, y = _batch(k)
        want = _eager_step(ref_net, ref_tr, x, y)
        assert torch.equal(step(x, y, batch_size=B), want), k
    _assert_same_state(ref_net, ref_tr, net, trainer)
    log = capture.retrace_log()
    assert len(log) == 1 and "rebound state" in log[0]["reason"]
    assert capture.stats()["capture_misses"] == 2


@pytest.mark.parametrize("how", ["set_learning_rate", "lr_scheduler"])
def test_rate_changes_take_effect_without_retrace(how):
    values = _values()

    def make():
        if how == "lr_scheduler":
            sched = mt.lr_scheduler.FactorScheduler(step=2, factor=0.5)
            return _lm(values, "adam", {"learning_rate": 1e-2,
                                        "lr_scheduler": sched})
        return _lm(values, "adam", {"learning_rate": 1e-2})

    ref_net, ref_tr = make()
    net, trainer = make()
    step = capture.capture(trainer, net=net, loss_fn=_loss_fn)
    rates = []
    for k in range(5):
        if how == "set_learning_rate" and k == 2:
            ref_tr.set_learning_rate(3e-3)
            trainer.set_learning_rate(3e-3)
        x, y = _batch(k)
        want = _eager_step(ref_net, ref_tr, x, y)
        assert torch.equal(step(x, y, batch_size=B), want), k
        rates.append(trainer.learning_rate)
    _assert_same_state(ref_net, ref_tr, net, trainer)
    assert len(set(rates)) > 1            # the rate did move
    s = capture.stats()
    assert s["capture_retraces"] == 0 and s["capture_misses"] == 1


def test_param_grad_after_a_captured_step_is_that_steps_gradient():
    values = _values()
    opt = {"learning_rate": 1e-3}
    ref_net, ref_tr = _lm(values, "adam", opt)
    net, trainer = _lm(values, "adam", opt)
    step = capture.capture(trainer, net=net, loss_fn=_loss_fn)
    for k in range(2):
        x, y = _batch(k)
        _eager_step(ref_net, ref_tr, x, y)
        step(x, y, batch_size=B)
        for (name, p), q in zip(ref_net._param_objects().items(),
                                net._param_objects().values()):
            if p.grad_req != "null":
                assert torch.equal(p.grad(), q.grad()), (k, name)


def test_capture_needs_net_and_loss_and_refuses_the_aot_cache(monkeypatch):
    net, trainer = _lm(_values(), "sgd", {})
    with pytest.raises(capture.CaptureError, match="net= and loss_fn="):
        capture.capture(trainer)
    monkeypatch.setenv("MXNET_TPU_TORCH_COMPILE_CACHE", "/nonexistent")
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        capture.capture(trainer, net=net, loss_fn=_loss_fn)


# ------------------------------------------------ ShardedTrainer, bitwise
NARROW = dict(layers=[1, 1, 1, 1], channels=[8, 16, 32, 64, 128],
              classes=10)
RESNET_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def _resnet_trainer(opt="sgd", opt_params=RESNET_OPT):
    net = tvision.resnet.ResNetV1(tvision.resnet.BottleneckV1, layout="NHWC",
                                  stem="s2d", prefix="net_", **NARROW)
    net.initialize(mt.init.Xavier(factor_type="in", magnitude=2),
                   ctx=mt.cpu(), generator=torch.Generator().manual_seed(2))
    return tpar.ShardedTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(),
                               opt, dict(opt_params),
                               mesh=tpar.create_mesh({"dp": 1}, [mt.cpu()]))


def _images(k, n=8):
    rng = np.random.RandomState(200 + k)
    return (rng.rand(n, 3, 32, 32).astype(np.float32),
            rng.randint(0, 10, n).astype(np.float32))


@pytest.mark.parametrize("opt,opt_params", [("sgd", RESNET_OPT),
                                            ("adam", {"learning_rate": 1e-3,
                                                      "wd": 1e-4})],
                         ids=["sgd", "adam"])
@pytest.mark.parametrize("microbatches", [None, 2])
def test_captured_sharded_step_bitwise_vs_eager(microbatches, opt,
                                                opt_params, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_TORCH_CAPTURE", "0")
    ref = _resnet_trainer(opt, opt_params)
    ref_losses = [ref.step(*_images(k), microbatches=microbatches)
                  for k in range(3)]
    assert capture.stats()["capture_fallback_eager"] == 3
    monkeypatch.delenv("MXNET_TPU_TORCH_CAPTURE")
    capture.reset_stats()
    tr = _resnet_trainer(opt, opt_params)
    step = capture.capture(tr)
    assert isinstance(step, capture.CapturedShardedStep)
    losses = [step(*_images(k), microbatches=microbatches)
              for k in range(3)]
    for a, b in zip(ref_losses, losses):
        assert torch.equal(a, b)
    for name in ref.params:
        assert torch.equal(ref.params[name], tr.params[name]), name
    for name in ref.aux:
        assert torch.equal(ref.aux[name], tr.aux[name]), name
    for name, s in ref.opt_state["state"].items():
        for a, b in zip(capture._leaves(s),
                        capture._leaves(tr.opt_state["state"][name])):
            assert torch.equal(a, b), name
    assert tr.opt_state["t"] == ref.opt_state["t"] == 3
    s = capture.stats()
    assert s["capture_steps"] == 3 and s["capture_misses"] == 1
    assert s["capture_hits"] == 2 and s["capture_retraces"] == 0
    assert s["capture_fallback_eager"] == 0


def test_sharded_set_learning_rate_writes_a_slot_without_retrace():
    ref, tr = _resnet_trainer(), _resnet_trainer()
    for k in range(3):
        if k == 1:
            ref.set_learning_rate(0.01)
            tr.set_learning_rate(0.01)
        x, y = _images(k)
        assert torch.equal(ref.step(x, y), tr.step(x, y)), k
    assert tr._slots.views[0].item() == np.float32(0.01)
    for name in ref.params:
        assert torch.equal(ref.params[name], tr.params[name]), name
    assert capture.stats()["capture_retraces"] == 0
    assert tr._capture_fingerprint() == ref._capture_fingerprint()
    x, y = _images(0)
    assert tr._capture_fingerprint(x, y, 2) != \
        tr._capture_fingerprint(x, y, None)


# ---------------------------------------------------------------- serving
def test_predictor_buckets_captured_equal_eager(monkeypatch):
    net, _ = _lm(_values(), "sgd", {})
    pred = serving.Predictor.from_block(
        net, input_shapes={"data": (T,)}, batch_sizes=(1, 4), ctx=mt.cpu(),
        warmup=False).warmup(dtype="int64")      # token ids pass uncast
    s = capture.stats()
    assert s["capture_misses"] == 2 and s["capture_retraces"] == 1
    capture.reset_stats()
    capture.clear_retrace_log()
    ids = [_batch(k)[0] for k in range(3)]
    got = [pred.predict(x[:n])[0] for x, n in zip(ids, (1, 3, 4))]
    assert capture.stats()["capture_retraces"] == 0
    assert capture.stats()["capture_hits"] == 3
    monkeypatch.setenv("MXNET_TPU_TORCH_CAPTURE", "0")
    want = [pred.predict(x[:n])[0] for x, n in zip(ids, (1, 3, 4))]
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    assert capture.stats()["capture_fallback_eager"] == 3
    monkeypatch.delenv("MXNET_TPU_TORCH_CAPTURE")
    # beyond the largest bucket: a new signature, captured and logged
    big = torch.cat([_batch(5)[0], _batch(6)[0]])
    out = pred.predict(big)[0]
    assert out.shape == (2 * B, T, CFG["vocab"])
    log = capture.retrace_log()
    assert len(log) == 1 and log[0]["label"] == "predictor"
    assert str(2 * B) in log[0]["reason"]


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
def test_failed_capture_raises_on_cuda():
    """A program that reads a device value on the host cannot be captured:
    the capture raises CaptureError, and nothing falls back to eager."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")

    def reads_host(x):
        return x * x.sum().item()

    ex = capture.CapturedExec(reads_host, label="bad", device="cuda")
    with pytest.raises(capture.CaptureError, match="capturing"):
        ex(torch.ones(4, device="cuda"))
    assert capture.stats()["capture_fallback_eager"] == 0

"""The health gates inside the port's captured gluon step
(``mxnet_tpu_torch/capture.py`` ``CapturedTrainerStep``), on the CPU.

A 2-layer fp32 ``TransformerLM(impl='flash')`` (as
``tests/test_torch_capture.py``) takes a few steps through
``capture.capture(trainer, net=, loss_fn=)`` with a ``HealthSentinel``
(``skip_batch``, ``raise``, ``rollback`` through a ``CheckpointManager``,
``check_every=2`` with a ``grad_norm_threshold`` that every step trips),
a ``loss_scaler=`` with a forced overflow, a ``skip`` / ``halt`` numerics
tap, the step fingerprint, and a stalled step. A ``nan_grad`` drill
poisons one step; a ``nonfinite_grad`` drill fires once a step on both
paths. Each run is held:

- bitwise to the same steps on the port's kill switch
  (``MXNET_TPU_TORCH_CAPTURE=0``): losses, parameters, optimizer states
  and update counts, fingerprints, the loss-scale trajectory, and the
  sentinel's and AMP's counters;
- within 1e-5 to ``mxnet_tpu``'s eager step: ``Trainer.step`` with the
  same sentinel attached and its own ``nan_grad`` drill; for the loss
  scaler ``mxnet_tpu``'s own kill-switch step (``MXNET_TPU_CAPTURE=0``),
  which scales, unscales and gates eagerly. ``mxnet_tpu``'s eager step has
  no tap gate; a halt / skip tap keeps a non-finite batch off the weights,
  so its oracle is the same eager run with that batch skipped (a
  ``skip_batch`` sentinel). ``mxnet_tpu``'s captured step is not the
  oracle (ROADMAP Queue 3).

A poisoned step that the gate holds back leaves every parameter and state
bitwise as it was, and its update counts (Adam's t) where they were.
"""
import contextlib
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import capture as jcapture  # noqa: E402
from mxnet_tpu.gluon.model_zoo import transformer as jzoo  # noqa: E402
from mxnet_tpu.resilience import faults as jfaults  # noqa: E402
from mxnet_tpu.resilience import sentinel as jsentinel  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import capture  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import transformer as tzoo  # noqa: E402
from mxnet_tpu_torch.observability import numerics  # noqa: E402
from mxnet_tpu_torch.resilience import (  # noqa: E402
    CheckpointManager, HealthSentinel, faults, integrity, sentinel)

CFG = dict(vocab=64, units=32, num_heads=2, num_layers=2, max_len=64)
B, T = 4, 16
ADAM = ("adam", {"learning_rate": 1e-2, "epsilon": 1e-3})
TOL = 1e-5
SENTINEL_KEYS = ("sentinel_checks", "sentinel_nonfinite",
                 "sentinel_grad_norm_trips", "sentinel_rollbacks",
                 "health_skipped_steps", "amp_overflow_skips")


def _loss_fn(out, y):
    return mt.gluon.loss.SoftmaxCrossEntropyLoss()(out, y).mean()


def _values(seed=5):
    net = tzoo.transformer_lm(impl="flash", prefix="tlm_", **CFG)
    net.initialize(mt.init.Xavier(), ctx=mt.cpu(),
                   generator=torch.Generator().manual_seed(seed))
    return {k: v.detach().numpy().copy()
            for k, v in net.collect_params().items()}


def _batch(k):
    rng = np.random.RandomState(200 + k)
    seq = np.zeros((B, T + 1), np.int64)
    seq[:, 0] = rng.randint(0, CFG["vocab"], B)
    for t in range(T):
        seq[:, t + 1] = (5 * seq[:, t] + 3) % CFG["vocab"]
    return seq[:, :-1], seq[:, 1:]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("MXNET_TPU_TORCH_CAPTURE", "MXNET_TPU_TORCH_COMPILE_CACHE",
              "MXNET_TPU_TORCH_INTEGRITY_FINGERPRINT",
              "MXNET_TPU_TORCH_INTEGRITY_AUDIT_EVERY",
              "MXNET_TPU_TORCH_NUMERICS", "MXNET_TPU_CAPTURE",
              "MXNET_TPU_TORCH_WATCHDOG_STEP_TIMEOUT"):
        monkeypatch.delenv(k, raising=False)
    capture.reset_stats()
    capture.clear_retrace_log()
    numerics.reset()
    yield
    numerics.reset()
    mt.amp.reset()
    mx.amp.reset()


def _states(trainer):
    return {i: [t.clone() for t in capture._leaves(s)]
            for i, s in trainer._updater.states.items()}


class _Run:
    """One run's record: per-step losses (None where the step raised),
    fingerprints, loss scales; the final parameters, states, update
    counts and counters."""

    def __init__(self):
        self.losses, self.fps, self.scales, self.raised = [], [], [], []


def _port_run(monkeypatch, values, steps, *, eager, poison=(), opt=ADAM,
              sentinel_kw=None, scaler_kw=None, tap_kw=None, fp=False,
              ckpt=None, snap=None, hook=None, loss_fn=_loss_fn):
    """``steps`` captured (or, with ``eager``, kill-switch) steps; the
    ``nan_grad`` drill armed on the steps in ``poison``; ``hook(k, step,
    parts)`` before step ``k``; with ``ckpt`` a checkpoint after step
    0."""
    if eager:
        monkeypatch.setenv("MXNET_TPU_TORCH_CAPTURE", "0")
    else:
        monkeypatch.delenv("MXNET_TPU_TORCH_CAPTURE", raising=False)
    if fp:
        monkeypatch.setenv("MXNET_TPU_TORCH_INTEGRITY_FINGERPRINT", "1")
    net = tzoo.transformer_lm(impl="flash", prefix="tlm_", **CFG)
    net.initialize(ctx=mt.cpu())
    net.load_numpy_params(values)
    trainer = mt.gluon.Trainer(net.collect_params(), opt[0], dict(opt[1]))
    mgr = CheckpointManager(str(ckpt)) if ckpt is not None else None
    snt = None
    if sentinel_kw is not None:
        snt = HealthSentinel(**sentinel_kw).attach(
            trainer, net=net, checkpoint_manager=mgr)
    scaler = mt.amp.LossScaler(**scaler_kw) if scaler_kw else None
    tap = numerics.NumericsTap(snapshot_dir=str(snap), **tap_kw) \
        if tap_kw else None
    step = capture.capture(trainer, net=net, loss_fn=loss_fn,
                           loss_scaler=scaler, numerics=tap)
    sentinel.reset_stats()
    run = _Run()
    parts = {"net": net, "trainer": trainer, "mgr": mgr, "scaler": scaler,
             "sentinel": snt}
    for k in range(steps):
        if hook is not None:
            hook(k, step, parts)
        x, y = (torch.from_numpy(a) for a in _batch(k))
        try:
            if k in poison:
                with faults.inject("nan_grad"):
                    loss = step(x, y, batch_size=B)
            else:
                loss = step(x, y, batch_size=B)
            run.raised.append(None)
        except Exception as e:  # a policy that raises
            loss = None
            run.raised.append(type(e).__name__)
        run.losses.append(None if loss is None else loss.detach().clone())
        run.fps.append(step.last_fingerprint)
        run.scales.append(scaler.loss_scale if scaler else None)
        if k == 0 and mgr is not None:
            mgr.save(1, net=net, trainer=trainer)
    run.params = {n: t.detach().clone()
                  for n, t in net.collect_params().items()}
    run.states = _states(trainer)
    run.counts = (trainer.optimizer.num_update,
                  dict(trainer.optimizer._index_update_count))
    run.sentinel = {k: sentinel.stats()[k] for k in SENTINEL_KEYS}
    run.capture = capture.stats()
    run.step = step
    run.net, run.trainer = net, trainer
    return run


def _bits(t):
    return t.detach().contiguous().view(torch.int32) \
        if t.dtype == torch.float32 else t


def _assert_bitwise(a, b):
    """Two port runs agree bit for bit (NaN payloads included)."""
    assert a.raised == b.raised
    for la, lb in zip(a.losses, b.losses):
        assert (la is None) == (lb is None)
        if la is not None:
            assert torch.equal(_bits(la), _bits(lb))
    assert a.fps == b.fps
    assert a.scales == b.scales
    for n in a.params:
        assert torch.equal(_bits(a.params[n]), _bits(b.params[n])), n
    assert sorted(a.states) == sorted(b.states)
    for i in a.states:
        for x, y in zip(a.states[i], b.states[i]):
            assert torch.equal(_bits(x), _bits(y)), i
    assert a.counts == b.counts
    assert a.sentinel == b.sentinel


def _captured_and_eager(monkeypatch, values, steps, **kw):
    cap = _port_run(monkeypatch, values, steps, eager=False, **kw)
    assert cap.capture["capture_fallback_eager"] == 0
    assert cap.capture["capture_misses"] >= 1
    capture.reset_stats()
    eag = _port_run(monkeypatch, values, steps, eager=True, **kw)
    assert eag.capture["capture_fallback_eager"] == steps
    _assert_bitwise(cap, eag)
    return cap, eag


# ------------------------------------------------------ mxnet_tpu's step
def _ref_net(values):
    jnet = jzoo.transformer_lm(impl="flash", prefix="tlm_", **CFG)
    jnet.initialize(mx.init.Zero())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jnet(mx.nd.array(np.zeros((1, 4)), dtype="int32"))
    for name, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(values[name]))
    return jnet


def _ref_run(values, steps, *, poison=(), skip=(), sentinel_kw=None,
             opt=ADAM, scaler_kw=None, hook=None, ckpt=None):
    """``mxnet_tpu``'s eager steps: ``Trainer.step`` with the sentinel
    attached (``skip``: steps whose update never lands; with ``ckpt`` a
    checkpoint after step 0), or with a loss scaler its kill-switch step.
    Returns (losses, params, scales, counters)."""
    from mxnet_tpu.resilience import CheckpointManager as JManager
    from mxnet_tpu.resilience import HealthSentinel as JSentinel

    jnet = _ref_net(values)
    jtr = mx.gluon.Trainer(jnet.collect_params(), opt[0], dict(opt[1]))
    jmgr = JManager(str(ckpt)) if ckpt is not None else None
    if sentinel_kw is not None:
        JSentinel(**sentinel_kw).attach(jtr, net=jnet,
                                        checkpoint_manager=jmgr)
    jce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def jloss_fn(out, y):
        return jce(out, y).mean()

    jstep = scaler = None
    if scaler_kw:
        scaler = mx.amp.LossScaler(**scaler_kw)
        jstep = jcapture.CapturedTrainerStep(jnet, jloss_fn, jtr,
                                             loss_scaler=scaler)
    jsentinel.reset_stats()
    losses, scales = [], []
    old = jcapture.os.environ.get("MXNET_TPU_CAPTURE")
    jcapture.os.environ["MXNET_TPU_CAPTURE"] = "0"
    try:
        for k in range(steps):
            if hook is not None:
                hook(k, scaler)
            xs, ys = _batch(k)
            x = mx.nd.array(xs, dtype="int32")
            y = mx.nd.array(ys, dtype="int32")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with (jfaults.inject("nan_grad") if k in poison
                      else contextlib.nullcontext()):
                    if jstep is not None:
                        loss = jstep(x, y, batch_size=B)
                    else:
                        with mx.autograd.record():
                            loss = jloss_fn(jnet(x), y)
                        loss.backward()
                        if k not in skip:
                            try:
                                jtr.step(B)
                            except jsentinel.NumericHealthError:
                                pass
            losses.append(float(loss.asnumpy()))
            scales.append(scaler.loss_scale if scaler else None)
            if k == 0 and jmgr is not None:
                jmgr.save(1, net=jnet, trainer=jtr)
    finally:
        if old is None:
            jcapture.os.environ.pop("MXNET_TPU_CAPTURE", None)
        else:
            jcapture.os.environ["MXNET_TPU_CAPTURE"] = old
    params = {n: p.data().asnumpy() for n, p in
              jnet.collect_params().items()}
    return losses, params, scales, {k: jsentinel.stats()[k]
                                    for k in SENTINEL_KEYS}


def _assert_near_ref(run, ref, counters=True):
    """Losses (where the port's step returned one), final parameters,
    scale trajectory and counters against mxnet_tpu's run."""
    losses, params, scales, stats = ref
    for k, (got, want) in enumerate(zip(run.losses, losses)):
        if got is None:
            continue
        got = float(got)
        assert abs(got - want) <= TOL * max(1.0, abs(want)), (k, got, want)
    for n, t in run.params.items():
        np.testing.assert_allclose(t.numpy(), params[n], rtol=0, atol=TOL,
                                   err_msg=n)
    if scales[0] is not None:
        assert run.scales == scales
    if counters:
        assert run.sentinel == stats


# ------------------------------------------------------------- the tests
@pytest.mark.parametrize("policy", ["skip_batch", "raise"])
def test_sentinel_gates_a_poisoned_step(monkeypatch, policy):
    """A nan_grad step under the sentinel: the update is held back in the
    graph, every parameter and state bitwise as before it, Adam's t not
    advanced; 'raise' raises NumericHealthError after the gate. Bitwise to
    the kill switch, within 1e-5 of mxnet_tpu's Trainer.step."""
    values = _values()
    kw = dict(sentinel_kw={"policy": policy}, poison=(2,))
    before = {}

    def hook(k, step, parts):
        if k == 2:
            before["params"] = {n: t.clone() for n, t in
                                parts["net"].collect_params().items()}
            before["states"] = _states(parts["trainer"])
            before["counts"] = dict(
                parts["trainer"].optimizer._index_update_count)

    cap, _ = _captured_and_eager(monkeypatch, values, 4, **kw)
    probe = _port_run(monkeypatch, values, 3, eager=False, hook=hook, **kw)
    for n, t in probe.params.items():
        assert torch.equal(t, before["params"][n]), n
    for i, st in probe.states.items():
        assert all(torch.equal(a, b) for a, b in
                   zip(st, before["states"][i]))
    assert probe.counts[1] == before["counts"]
    want_raise = "NumericHealthError" if policy == "raise" else None
    assert cap.raised == [None, None, want_raise, None]
    assert cap.counts[0] == 3
    assert cap.sentinel["sentinel_checks"] == 4
    assert cap.sentinel["sentinel_nonfinite"] == 1
    assert cap.sentinel["health_skipped_steps"] == (policy == "skip_batch")
    _assert_near_ref(cap, _ref_run(values, 4, poison=(2,),
                                   sentinel_kw={"policy": policy}))


def test_sentinel_rollback_restores_the_checkpoint(monkeypatch, tmp_path):
    """'rollback': the poisoned step restores the checkpoint taken after
    step 0 (parameters, states, counts) through the CheckpointManager and
    is skipped; the restored tensors are bound anew, so the graph is
    captured again with its reason. Bitwise to the kill switch, within
    1e-5 of mxnet_tpu's Trainer.step with its own manager."""
    values = _values()
    kw = dict(sentinel_kw={"policy": "rollback"}, poison=(2,))
    cap = _port_run(monkeypatch, values, 4, eager=False,
                    ckpt=tmp_path / "cap", **kw)
    assert any("rebound" in e["reason"] for e in capture.retrace_log())
    eag = _port_run(monkeypatch, values, 4, eager=True,
                    ckpt=tmp_path / "eag", **kw)
    _assert_bitwise(cap, eag)
    assert cap.sentinel["sentinel_rollbacks"] == 1
    assert cap.sentinel["health_skipped_steps"] == 1
    assert cap.counts[0] == 2         # step 0's, then step 3's
    _assert_near_ref(cap, _ref_run(values, 4, poison=(2,),
                                   sentinel_kw={"policy": "rollback"},
                                   ckpt=tmp_path / "ref"))


def test_nonfinite_grad_drill_fires_once_a_step(monkeypatch, tmp_path):
    """nonfinite_grad armed at its third call fires at step 2, once, on
    the captured step (the target's weight poisoned, so that step's loss
    is NaN) and on the kill switch (the target's gradient), as
    mxnet_tpu's captured step and its eager step do. Under 'rollback'
    that step is flagged and restored on both paths: every other loss,
    the parameters, states, counts and counters after the run are
    bitwise."""
    values = _values()
    runs = {}
    for eager in (False, True):
        with faults.inject("nonfinite_grad", at_step=2, times=1) as f:
            runs[eager] = _port_run(
                monkeypatch, values, 4, eager=eager,
                sentinel_kw={"policy": "rollback"}, ckpt=tmp_path / (
                    "eag" if eager else "cap"))
        assert (f.calls, f.fired) == (4, 1)
    cap, eag = runs[False], runs[True]
    assert torch.isnan(cap.losses[2]) and torch.isfinite(eag.losses[2])
    cap.losses[2] = eag.losses[2] = None
    _assert_bitwise(cap, eag)
    assert cap.raised == [None] * 4
    assert cap.sentinel["sentinel_rollbacks"] == 1
    assert cap.sentinel["sentinel_nonfinite"] == 1
    assert cap.counts[0] == 2         # step 0's, then step 3's


def test_check_every_and_the_grad_norm_trip(monkeypatch):
    """check_every=2 with a grad_norm_threshold every step exceeds: steps
    0 and 2 are checked, trip and are skipped; steps 1 and 3 land (the
    cadence slot opens the gate off cadence). The trips count as
    sentinel_grad_norm_trips, none as non-finite."""
    values = _values()
    skw = {"policy": "skip_batch", "grad_norm_threshold": 1e-6,
           "check_every": 2}
    cap, _ = _captured_and_eager(monkeypatch, values, 4, sentinel_kw=skw)
    assert cap.sentinel["sentinel_checks"] == 2
    assert cap.sentinel["sentinel_grad_norm_trips"] == 2
    assert cap.sentinel["sentinel_nonfinite"] == 0
    assert cap.counts[0] == 2          # two updates landed
    _assert_near_ref(cap, _ref_run(values, 4, sentinel_kw=skw))


def test_loss_scaler_with_a_forced_overflow(monkeypatch):
    """loss_scaler= on the fp32 LM: the scale a slot, the loss scaled and
    the gradients unscaled in the graph; a scale of 2**200 (inf in
    float32) overflows step 2, which is skipped, the scale cut by the
    factor, amp_overflow_skips counted. The trajectory equals the kill
    switch's and mxnet_tpu's kill-switch step's."""
    values = _values()
    skw = {"init_scale": 2. ** 4, "scale_factor": 2. ** 190,
           "scale_window": 1000}

    def hook(k, step, parts):
        if k == 2:
            parts["scaler"].loss_scale = 2. ** 200

    def jhook(k, scaler):
        if k == 2:
            scaler.loss_scale = 2. ** 200

    cap, _ = _captured_and_eager(monkeypatch, values, 4, scaler_kw=skw,
                                 hook=hook)
    assert cap.scales == [16.0, 16.0, 2. ** 10, 2. ** 10]
    assert cap.sentinel["amp_overflow_skips"] == 1
    assert cap.sentinel["health_skipped_steps"] == 1
    assert cap.counts[0] == 3
    assert cap.step.loss_scaler._noted_finite is True   # noted, unread
    _assert_near_ref(cap, _ref_run(values, 4, scaler_kw=skw, hook=jhook))


@pytest.mark.parametrize("policy", ["skip", "halt"])
def test_numerics_tap_gates_a_poisoned_step(monkeypatch, tmp_path, policy):
    """A skip / halt tap (sampling every step) gates a nan_grad step in
    the graph: weights and states bitwise unchanged; 'halt' raises
    NumericsDivergenceError after the gate. gates_updates is mxnet_tpu's
    for every policy, and the graph's key carries it."""
    from mxnet_tpu.observability import numerics as jnumerics

    for p in numerics.POLICIES:
        assert numerics.NumericsTap(policy=p).gates_updates == \
            jnumerics.NumericsTap(policy=p).gates_updates
    values = _values()
    kw = dict(tap_kw={"interval": 1, "policy": policy}, poison=(1,),
              snap=tmp_path)
    cap, _ = _captured_and_eager(monkeypatch, values, 3, **kw)
    want = "NumericsDivergenceError" if policy == "halt" else None
    assert cap.raised == [None, want, None]
    assert cap.counts[0] == 2
    assert numerics.condition("nonfinite")["active"]
    _assert_near_ref(cap, _ref_run(values, 3, skip=(1,)), counters=False)
    key_tap_gates = -2                  # (..., tap_gates, drill)
    assert all(s[key_tap_gates] is True
               for s in cap.step._exec.compiled_signatures)


def test_fingerprint_is_folded_after_the_select(monkeypatch):
    """With the fingerprint on, a gated step's fingerprint digests the
    parameters as they landed (the pre-step values) and the poisoned
    gradients: it equals the host fold of the net's state after the step,
    on the captured path and the kill switch alike."""
    values = _values()
    seen = []

    def hook(k, step, parts):
        if k == 3:     # after the poisoned step 2
            seen.append(integrity.step_fold_host(
                *integrity.net_named_state(parts["net"])))

    kw = dict(sentinel_kw={"policy": "skip_batch"}, poison=(2,), fp=True,
              hook=hook)
    cap, _ = _captured_and_eager(monkeypatch, values, 4, **kw)
    assert all(f is not None for f in cap.fps)
    assert seen[0] == cap.fps[2] == seen[1]
    assert len(set(cap.fps)) == 4
    _assert_near_ref(cap, _ref_run(values, 4, poison=(2,),
                                   sentinel_kw={"policy": "skip_batch"}))


def test_a_stall_restores_the_optimizer_bookkeeping(monkeypatch, tmp_path):
    """A step that stalls past the step deadline inside the captured
    program raises StallError, and the host replay's advance (update
    counts, Adam's t, the lr schedule) is taken back; training goes on
    bitwise with the kill switch's run of the same stall, and within 1e-5
    of mxnet_tpu's eager run in which that step's update never lands."""
    monkeypatch.setenv("MXNET_TPU_TORCH_CRASH_DIR", str(tmp_path))
    values = _values()
    calls = {}

    def slow_loss(out, y):
        calls["n"] += 1
        if calls.get("stall") == calls["n"]:
            t0 = time.time()
            while time.time() - t0 < 5:
                time.sleep(0.01)
        return _loss_fn(out, y)

    def hook(k, step, parts):
        if k == 2:      # the deadline armed for the stalled step alone
            monkeypatch.setenv("MXNET_TPU_TORCH_WATCHDOG_STEP_TIMEOUT",
                               "1.0")
            calls["stall"] = calls["n"] + 1
            sched = parts["trainer"].optimizer.lr_scheduler
            calls["sched"] = dict(vars(sched))
            calls["counts"] = dict(
                parts["trainer"].optimizer._index_update_count)
        if k == 3:      # after the stall: the replay's advance was undone
            monkeypatch.delenv("MXNET_TPU_TORCH_WATCHDOG_STEP_TIMEOUT")
            opt = parts["trainer"].optimizer
            calls["after"] = (dict(vars(opt.lr_scheduler)),
                              dict(opt._index_update_count))

    runs = []
    for eager in (False, True):
        calls.clear()
        calls["n"] = 0
        sched = mt.lr_scheduler.FactorScheduler(step=1, factor=0.9,
                                                base_lr=1e-2)
        opt = ("adam", {"learning_rate": 1e-2, "epsilon": 1e-3,
                        "lr_scheduler": sched})
        run = _port_run(monkeypatch, values, 4, eager=eager, opt=opt,
                        sentinel_kw={"policy": "skip_batch"}, hook=hook,
                        loss_fn=slow_loss)
        assert run.raised == [None, None, "StallError", None]
        assert calls["after"] == (calls["sched"], calls["counts"])
        assert run.counts[0] == 3
        runs.append(run)
    _assert_bitwise(*runs)
    assert runs[0].capture["capture_fallback_eager"] == 0
    jopt = ("adam", {"learning_rate": 1e-2, "epsilon": 1e-3,
                     "lr_scheduler": mx.lr_scheduler.FactorScheduler(
                         step=1, factor=0.9, base_lr=1e-2)})
    _assert_near_ref(runs[0], _ref_run(values, 4, skip=(2,), opt=jopt),
                     counters=False)

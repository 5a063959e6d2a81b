"""The port's fault harness, health sentinel, watchdog and the serving
errors they drive (``mxnet_tpu_torch/resilience``,
``serving/batcher.py``), against ``mxnet_tpu``'s on the CPU, after
``tests/test_resilience.py``, ``tests/test_watchdog.py`` and
``tests/test_serving.py``.

The same fault spec parses to the same armed table in both packages, and
each serving hook fires at the same calls with the same effect (NaN
batches, bit flips, inflated counters, square waves). The sentinel gives
the same verdict on the same arrays. A deadline, a shed, a sentinel trip
and a stalled batch fail with the same structured error types in the
same scenarios, on a 1-bucket Dense(4) Predictor in each package (weights
from one numpy seed). Training kinds, whose hooks the port lacks, raise
when armed.
"""
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import serving as jserving  # noqa: E402
from mxnet_tpu.resilience import faults as jfaults  # noqa: E402
from mxnet_tpu.resilience import sentinel as jsentinel  # noqa: E402
from mxnet_tpu.resilience import watchdog as jwatchdog  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import serving  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.resilience import faults, sentinel, watchdog  # noqa
from mxnet_tpu_torch.resilience import HealthSentinel  # noqa: E402

import _torch_fleet_factories as ff  # noqa: E402

X1 = np.ones((1, ff.IN_UNITS), np.float32)
DEADLINE = 0.5


def _ref_predictor(seed=7, prefix="flt_t_"):
    net = mx.gluon.nn.Dense(4, in_units=ff.IN_UNITS, prefix=prefix)
    net.initialize()
    params = net.collect_params()
    for k, v in ff.dense_params(seed).items():
        params[prefix + k].set_data(mx.nd.array(v))
    return jserving.Predictor.from_block(
        net, input_shapes={"data": (ff.IN_UNITS,)}, batch_sizes=(4,),
        warmup=False)


PKGS = {"port": (serving, faults, ff.dense_predictor, "MXNET_TPU_TORCH_"),
        "ref": (jserving, jfaults, _ref_predictor, "MXNET_TPU_")}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for f in (faults, jfaults):
        f.reset()
    serving.reset_stats()
    jserving.reset_stats()
    monkeypatch.setenv("MXNET_TPU_TORCH_FAULT_HANG_CAP", "5")
    monkeypatch.setenv("MXNET_TPU_FAULT_HANG_CAP", "5")
    yield
    for f in (faults, jfaults):
        f.reset()


def _host(o):
    return o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)


# --------------------------------------------------------------- the spec

SPEC = ("replica_crash@2,replica_nan_storm@0:4,slo_burn@1:*,"
        "hang_batch,kv_pool_exhaustion@3:2,decode_replica_death@0:1")


def _table(flt):
    return sorted((k, f.at_step, f.times) for k, f in flt._ACTIVE.items())


def test_env_spec_arms_the_same_table(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FAULTS", SPEC)
    monkeypatch.setenv("MXNET_TPU_TORCH_FAULTS", SPEC)
    jfaults._install_from_env()
    faults.install_from_env()
    assert _table(faults) == _table(jfaults)
    assert _table(faults) == [
        ("decode_replica_death", 0, 1), ("hang_batch", 0, 1),
        ("kv_pool_exhaustion", 3, 2), ("replica_crash", 2, 1),
        ("replica_nan_storm", 0, 4), ("slo_burn", 1, None)]


def test_parse_spec_knows_every_mxnet_tpu_kind():
    """Every kind ``mxnet_tpu``'s docstring lists parses; the serving
    kinds and the ported training kinds arm (the dist store's, the peers',
    the pod hosts' and ``ckpt_partial_pod`` among them); the one kind still
    queued, ``record_corrupt``, raises naming ROADMAP Queue 1 item 10; an
    unknown kind raises."""
    doc_kinds = {k for k in faults.SERVING_KINDS + faults.TRAINING_KINDS}
    listed = {line.strip().split("``")[1] for line in
              jfaults.__doc__.splitlines()
              if line.strip().startswith("- ``")}
    assert listed == doc_kinds
    assert faults.parse_spec("nan_grad@3,preempt") == [
        ("nan_grad", 3, 1), ("preempt", 0, 1)]
    for kind in faults.TRAINING_KINDS:
        if kind in faults.QUEUED_KINDS:
            with pytest.raises(MXNetError, match="item "
                               f"{faults.QUEUED_KINDS[kind]}"):
                faults.arm(kind)
        else:
            with faults.inject(kind) as f:
                assert faults.active(kind) and f.fired == 0
    assert faults.QUEUED_KINDS == {"record_corrupt": 10}
    assert not faults.active()
    with pytest.raises(MXNetError, match="unknown fault kind"):
        faults.parse_spec("no_such_fault")
    with pytest.raises(MXNetError, match="unknown fault kind"):
        faults.arm("no_such_fault")


def _fire_pattern(flt, kind, hook, n=6, **arm):
    with flt.inject(kind, **arm) as f:
        out = [hook() for _ in range(n)]
    return out, f.fired, f.calls


@pytest.mark.parametrize("arm", [dict(at_step=2, times=2),
                                 dict(at_step=0, times=None),
                                 dict(at_step=1, times=1)])
def test_hooks_fire_at_the_same_calls(arm, monkeypatch):
    """Replica-addressed hooks fire only on the victim, at the same calls,
    in both packages; the counters follow."""
    for prefix in ("MXNET_TPU_TORCH_", "MXNET_TPU_"):
        monkeypatch.setenv(prefix + "FAULT_REPLICA", "1")

    def crash(flt):
        def hook():
            try:
                flt.maybe_replica_crash(1)
                flt.maybe_replica_crash(0)    # never the victim
                return False
            except flt.ReplicaCrash:
                return True
        return hook

    got = _fire_pattern(faults, "replica_crash", crash(faults), **arm)
    want = _fire_pattern(jfaults, "replica_crash", crash(jfaults), **arm)
    assert got == want
    got = _fire_pattern(faults, "kv_pool_exhaustion",
                        lambda: faults.maybe_kv_pool_exhaustion(7), **arm)
    want = _fire_pattern(jfaults, "kv_pool_exhaustion",
                         lambda: jfaults.maybe_kv_pool_exhaustion(7), **arm)
    assert got == want


def test_value_hooks_match(monkeypatch):
    """slo_burn, canary_slo_regression and autoscale_flap transform their
    signal identically."""
    counters = {"fleet_requests": 10, "fleet_deadline_exceeded": 1,
                "fleet_shed_overloaded": 2}
    for flt in (faults, jfaults):
        with flt.inject("slo_burn"):
            burned = flt.maybe_slo_burn(counters)
        assert burned == {"fleet_requests": 74, "fleet_deadline_exceeded": 65,
                          "fleet_shed_overloaded": 2}
    got = _fire_pattern(faults, "canary_slo_regression",
                        lambda: faults.maybe_canary_slo_regression(0.25),
                        times=2, at_step=1)
    want = _fire_pattern(jfaults, "canary_slo_regression",
                         lambda: jfaults.maybe_canary_slo_regression(0.25),
                         times=2, at_step=1)
    assert got == want and got[0] == [0.25, 2.5, 2.5, 0.25, 0.25, 0.25]
    got = _fire_pattern(faults, "autoscale_flap",
                        lambda: faults.maybe_autoscale_flap(3.0), times=None)
    want = _fire_pattern(jfaults, "autoscale_flap",
                         lambda: jfaults.maybe_autoscale_flap(3.0),
                         times=None)
    assert got == want and got[0] == [1e6, 0.0] * 3


def test_poison_hooks_match_and_refuse_integer_batches(monkeypatch):
    """nan_serving / replica_nan_storm / rollout_bad_weights replace the
    first floating-point entry with NaNs, in place of the same entry;
    an all-integer batch raises without burning the fire."""
    feeds = {"ids": np.arange(4, dtype=np.int32).reshape(1, 4),
             "x": np.ones((1, 3), np.float32),
             "y": np.ones((1, 2), np.float32)}
    tfeeds = {k: torch.from_numpy(v) for k, v in feeds.items()}
    with faults.inject("nan_serving") as f, jfaults.inject("nan_serving"):
        got = faults.maybe_nan_batch(tfeeds)
        want = jfaults.maybe_nan_batch(feeds)
    assert f.fired == 1
    for k in feeds:
        np.testing.assert_array_equal(_host(got[k]), want[k])
    assert np.isnan(_host(got["x"])).all()
    for flt in (faults, jfaults):
        with flt.inject("replica_nan_storm") as f:
            with pytest.raises(flt.FaultInjected, match="floating-point"):
                flt.maybe_replica_nan_storm(0, {"ids": feeds["ids"]})
        assert f.fired == 0
    params = {"w": torch.ones(2, 2), "b": torch.zeros(2)}
    with faults.inject("rollout_bad_weights") as f:
        bad = faults.maybe_rollout_bad_weights(params)
    assert f.fired == 1 and torch.isnan(bad["w"]).all()
    assert bad["b"] is params["b"]


def test_sdc_serving_flips_the_same_bit():
    outs = [np.array([[1.5, -2.25]], np.float32), np.arange(3)]
    with faults.inject("sdc_serving"), jfaults.inject("sdc_serving"):
        got, n = faults.maybe_sdc_serving(
            0, ([torch.from_numpy(outs[0].copy()),
                 torch.from_numpy(outs[1])], 1))
        want, _ = jfaults.maybe_sdc_serving(0, (outs, 1))
    assert n == 1
    np.testing.assert_array_equal(_host(got[0]).view(np.uint32),
                                  np.asarray(want[0]).view(np.uint32))
    assert not np.array_equal(_host(got[0]), outs[0])
    bf = torch.tensor([1.0, 2.0], dtype=torch.bfloat16)
    flipped = faults._flip_low_bit(bf)
    assert flipped.view(torch.int16)[0] == bf.view(torch.int16)[0] ^ 1


def test_int8_calib_mismatch_is_refused():
    from mxnet_tpu_torch import symbol as tsym
    from mxnet_tpu_torch.contrib import quantization as tq

    data = tsym.Variable("data")
    s = tsym.FullyConnected(data, num_hidden=4, name="cm_fc")
    args = {"cm_fc_weight": torch.ones(4, 3), "cm_fc_bias": torch.zeros(4)}
    table = tq.calibrate(
        s, args, {}, mt.io.NDArrayIter(np.ones((4, 3), np.float32),
                                       batch_size=2), calib_mode="naive",
        ctx=mt.cpu())
    tq.quantize_model(s, args, {}, calib_table=table, quantize_mode="full")
    with faults.inject("int8_calib_mismatch") as f:
        with pytest.raises(tq.CalibrationMismatchError, match="digest"):
            tq.quantize_model(s, args, {}, calib_table=table,
                              quantize_mode="full")
    assert f.fired == 1


def test_kv_pool_exhaustion_backpressures():
    pool = serving.PagePool(8)
    with faults.inject("kv_pool_exhaustion", times=2):
        assert pool.alloc(1) is None and pool.alloc(1) is None
        assert pool.alloc(2) is not None
    assert serving.stats()["decode_backpressure"] == 2


def test_fired_faults_counted():
    faults.reset_stats()
    with faults.inject("hang_batch", at_step=5):
        faults.maybe_hang("hang_batch")
    assert faults.stats() == {"faults_armed": 1, "faults_fired": 0}


# ------------------------------------------------------------ the sentinel

ARRAYS = {
    "finite": [np.ones((2, 3), np.float32), np.arange(4)],
    "nan": [np.ones((2, 3), np.float32),
            np.array([1.0, np.nan], np.float32)],
    "inf": [np.array([[np.inf]], np.float32)],
    "neg_inf": [np.array([-np.inf, 0.0], np.float64)],
    "ints": [np.arange(5), np.zeros((2, 2), np.int8)],
    "empty": [],
    "zero_size": [np.zeros((0, 3), np.float32)],
}


@pytest.mark.parametrize("case", sorted(ARRAYS))
@pytest.mark.parametrize("policy", ["skip_batch", "raise"])
def test_sentinel_verdicts_match(case, policy):
    """The same verdict on the same arrays, given as numpy or as tensors
    (bf16 included), under both policies."""
    arrays = ARRAYS[case]
    verdicts = []
    for sent, arrs in (
            (HealthSentinel(policy), arrays),
            (HealthSentinel(policy), [torch.from_numpy(a) for a in arrays]),
            (HealthSentinel(policy), [torch.from_numpy(a).to(torch.bfloat16)
                                      if a.dtype.kind == "f" else
                                      torch.from_numpy(a) for a in arrays]),
            (jsentinel.HealthSentinel(policy), arrays)):
        try:
            verdicts.append(sent.check_finite(arrs, what="x"))
        except (sentinel.NumericHealthError,
                jsentinel.NumericHealthError) as e:
            verdicts.append(type(e).__name__)
    assert len(set(verdicts)) == 1, verdicts
    bad = case in ("nan", "inf", "neg_inf")
    assert verdicts[0] == (("NumericHealthError" if policy == "raise"
                            else False) if bad else True)


def test_sentinel_attach_raises_naming_item_12():
    """Attaching is ported: the sentinel hooks the trainer, a rollback
    policy needs a manager and the net, and detach unhooks it."""

    class _Trainer:
        _sentinel = None

    tr = _Trainer()
    s = HealthSentinel(policy="skip_batch").attach(tr)
    assert tr._sentinel is s and s.detach() is s and tr._sentinel is None
    with pytest.raises(ValueError, match="CheckpointManager"):
        HealthSentinel(policy="rollback").attach(tr)
    with pytest.raises(ValueError, match="needs the net"):
        HealthSentinel(policy="rollback").attach(tr,
                                                  checkpoint_manager=object())


# ------------------------------------------- structured errors in serving


def _errors(pkg, monkeypatch):
    """Deadline, shed, sentinel trip: the error type names each scenario
    raises."""
    srv, flt, make, _ = PKGS[pkg]
    names = {}
    pred = make()
    with srv.BatchServer(pred, max_batch_size=4, batch_timeout_ms=1.0) as s:
        s.submit(X1).result(timeout=60)
        for budget in (0, -1.0):
            with pytest.raises(Exception) as ei:
                s.submit(X1, deadline_ms=budget).result(timeout=10)
            names[f"spent_{budget}"] = type(ei.value).__name__
        with flt.inject("nan_serving"):
            with pytest.raises(Exception) as ei:
                s.submit(X1).result(timeout=60)
        names["nan"] = type(ei.value).__name__
        names["after_nan"] = _host(s.submit(X1).result(timeout=60)[0])
    with srv.BatchServer(pred, max_batch_size=4, batch_timeout_ms=1.0,
                         check_health=False, sentinel=None) as s:
        with flt.inject("nan_serving"):
            out = s.submit(X1).result(timeout=60)
        names["unchecked_nan"] = bool(np.isnan(_host(out[0])).all())
    # a request expires while its queue is blocked behind a slow batch
    slow = srv.BatchServer(pred, max_batch_size=1, batch_timeout_ms=1.0,
                           max_queue_depth=2)
    real = pred.predict_raw
    gate, started = threading.Event(), threading.Event()

    def blocked(feeds):
        started.set()
        gate.wait(10)
        return real(feeds)

    pred.predict_raw = blocked
    try:
        head = slow.submit(X1)
        assert started.wait(10)              # the worker holds it
        late = slow.submit(X1, deadline_ms=50)
        q2 = slow.submit(X1)
        shed = slow.submit(X1)               # 3rd queued: over depth 2
        time.sleep(0.2)
        gate.set()
        for key, fut in (("late", late), ("shed", shed)):
            with pytest.raises(Exception) as ei:
                fut.result(timeout=30)
            names[key] = type(ei.value).__name__
        head.result(timeout=30)
        q2.result(timeout=30)
    finally:
        pred.predict_raw = real
        slow.close()
    oldest = srv.BatchServer(pred, max_batch_size=1, batch_timeout_ms=1.0,
                             max_queue_depth=1, shed_policy="reject_oldest")
    gate.clear()
    started.clear()
    pred.predict_raw = blocked
    try:
        head = oldest.submit(X1)
        assert started.wait(10)
        first = oldest.submit(X1)
        second = oldest.submit(X1)
        gate.set()
        with pytest.raises(Exception) as ei:
            first.result(timeout=30)
        names["reject_oldest"] = type(ei.value).__name__
        second.result(timeout=30)
        head.result(timeout=30)
    finally:
        pred.predict_raw = real
        oldest.close()
    counters = {k: srv.stats()[k] for k in (
        "serving_shed_deadline", "serving_shed_overload",
        "serving_poisoned_batches")}
    return names, counters


def test_deadline_shed_and_sentinel_errors_match(monkeypatch):
    got, got_c = _errors("port", monkeypatch)
    want, want_c = _errors("ref", monkeypatch)
    np.testing.assert_allclose(got.pop("after_nan"), want.pop("after_nan"),
                               rtol=1e-6, atol=1e-6)
    assert got == want
    assert got == {"spent_0": "DeadlineExceeded",
                   "spent_-1.0": "DeadlineExceeded",
                   "nan": "NumericHealthError", "unchecked_nan": True,
                   "late": "DeadlineExceeded", "shed": "ServerOverloaded",
                   "reject_oldest": "ServerOverloaded"}
    assert got_c == want_c
    assert got_c == {"serving_shed_deadline": 3, "serving_shed_overload": 2,
                     "serving_poisoned_batches": 1}


def test_queue_depth_and_outstanding():
    pred = ff.dense_predictor()
    real = pred.predict_raw
    gate, started = threading.Event(), threading.Event()
    pred.predict_raw = lambda feeds: (started.set(), gate.wait(10),
                                      real(feeds))[2]
    with serving.BatchServer(pred, max_batch_size=1,
                             batch_timeout_ms=1.0) as s:
        futs = [s.submit(X1)]
        assert started.wait(10)
        futs += [s.submit(X1) for _ in range(3)]
        assert s.queue_depth == 3 and s.outstanding == 4
        gate.set()
        for f in futs:
            f.result(timeout=30)
        assert s.queue_depth == 0


# ------------------------------------------------------------ the watchdog


def test_guard_noop_when_unconfigured(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_TORCH_WATCHDOG_BATCH_TIMEOUT",
                       raising=False)
    assert watchdog.timeout_for("batch") is None
    with watchdog.guard("batch") as g:
        assert g is None
    monkeypatch.setenv("MXNET_TPU_TORCH_WATCHDOG_PROBE_TIMEOUT", "2.5")
    assert watchdog.timeout_for("probe") == 2.5


def test_stall_raises_within_two_deadlines(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_TORCH_CRASH_DIR", str(tmp_path))
    t0 = time.monotonic()
    with pytest.raises(watchdog.StallError) as ei:
        with watchdog.guard("batch", timeout=DEADLINE, detail="x_site"):
            while True:
                time.sleep(0.01)
    assert time.monotonic() - t0 < 2 * DEADLINE + 1.0
    err = ei.value
    assert (err.phase, err.detail, err.timeout) == ("batch", "x_site",
                                                    DEADLINE)
    with open(err.report_path) as f:
        assert json.load(f)["kind"] == "stall"


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_batchserver_stall_fails_only_its_batch(pkg, monkeypatch, tmp_path):
    srv, flt, make, prefix = PKGS[pkg]
    monkeypatch.setenv(prefix + "WATCHDOG_BATCH_TIMEOUT", str(DEADLINE))
    monkeypatch.setenv(prefix + "CRASH_DIR", str(tmp_path))
    pred = make()
    with srv.BatchServer(pred, max_batch_size=4, batch_timeout_ms=1.0) as s:
        s.submit(X1).result(timeout=60)
        t0 = time.monotonic()
        with flt.inject("hang_batch"):
            with pytest.raises(Exception) as ei:
                s.submit(X1).result(timeout=30)
        assert type(ei.value).__name__ == "StallError"
        assert time.monotonic() - t0 < 2 * DEADLINE + 2.0
        s.submit(X1).result(timeout=30)      # the queue still serves
    assert srv.stats()["serving_stalled_batches"] == 1


def test_batchserver_close_drain_bounded():
    pred = ff.dense_predictor()
    real = pred.predict_raw

    def wedged(feeds):
        t0 = time.monotonic()
        while time.monotonic() - t0 < 10:
            time.sleep(0.01)
        return real(feeds)

    pred.predict_raw = wedged
    s = serving.BatchServer(pred, max_batch_size=4, batch_timeout_ms=1.0)
    inflight = s.submit(X1)
    time.sleep(0.3)
    queued = s.submit(X1)
    t0 = time.monotonic()
    s.close(drain=True, timeout=DEADLINE)
    assert time.monotonic() - t0 < 2 * DEADLINE + 1.0
    for fut in (inflight, queued):
        with pytest.raises(serving.ServerClosed):
            fut.result(timeout=1)


def test_peer_bookkeeping():
    watchdog.reset_peers()
    watchdog.mark_peer_dead(3)
    watchdog.mark_peer_dead(3)
    watchdog.mark_peer_dead(5)
    assert watchdog.dead_peers() == [3, 5]
    assert mt.kv.create("local").excise_dead_peers(ranks=[5]) == [5]
    assert watchdog.dead_peers() == [3]
    watchdog.reset_peers()


# ---------------------------------------------------------- decode death


def test_decode_replica_death_fails_streams_and_frees_pages():
    """No death sink: every stream of the dead engine fails with
    DecodeReplicaDead and every page returns to the pool."""
    from mxnet_tpu_torch.gluon.model_zoo import transformer as tzoo

    net = tzoo.transformer_lm(vocab=40, units=24, num_heads=2, num_layers=1,
                              max_len=48, prefix="tlm_")
    net.initialize(ctx=mt.cpu())
    pred = serving.DecodePredictor(net, ctx=mt.cpu(), page_size=4,
                                   num_pages=16, max_seqs=2,
                                   prefill_buckets=(8,))
    bat = serving.DecodeBatcher(pred, ttft_slo_ms=60000)
    with faults.inject("decode_replica_death", at_step=2):
        streams = [bat.submit([1, 2, 3], 20), bat.submit([4, 5], 20)]
        for s in streams:
            with pytest.raises(faults.DecodeReplicaDead):
                s.result(timeout=60)
    assert bat.dead and pred.pool.in_use == 0
    with pytest.raises(serving.ServerClosed):
        bat.submit([1], 2)
    bat.close()

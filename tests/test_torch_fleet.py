"""The port's serving fleet (``mxnet_tpu_torch/serving/fleet.py``) against
``mxnet_tpu``'s, on the CPU, after ``tests/test_fleet.py``.

Replicas are 1-bucket Predictors of a Dense(4) over 3 inputs (weights from
a numpy seed, the same in both packages), a 2-layer
``TransformerLM(impl='flash')`` (K1's plain version on the CPU) for the
answers held to ``mxnet_tpu``'s net, a ResNet-18 Symbol at 32x32 for the
``{fp32, int8}`` variant group, and a 1-layer LM behind
``DecodePredictor`` for ``StreamRouter``.
Each drill (``replica_crash``, ``replica_hang``, ``replica_nan_storm``,
the kill hammer) runs on both packages' fleets with the same settings;
the victim's walk through the supervisor's states and the router's
retry / breaker / shed counters must agree, and every admitted request
must terminate. Probes run once a minute in the drills, so only the
requests move the state machine. Tolerances: answers bitwise within one
package, the LM's within 1e-5 of max|logit| against ``mxnet_tpu``'s
net, decode tokens exactly (fp32).
"""
import functools
import os
import threading
import time
import warnings
from concurrent import futures as _futures

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import serving as jserving  # noqa: E402
from mxnet_tpu.gluon.model_zoo import transformer as jzoo  # noqa: E402
from mxnet_tpu.resilience import faults as jfaults  # noqa: E402
from mxnet_tpu.resilience import watchdog as jwatchdog  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import serving  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import transformer as tzoo  # noqa: E402
from mxnet_tpu_torch.resilience import faults, watchdog  # noqa: E402
from mxnet_tpu_torch.serving import fleet as fleet_mod  # noqa: E402
from mxnet_tpu_torch.serving.batcher import (DeadlineExceeded,  # noqa: E402
                                             ServerClosed)

import _torch_fleet_factories as ff  # noqa: E402

X1 = np.ones((1, ff.IN_UNITS), np.float32)
DRILL_COUNTERS = ("fleet_retries", "fleet_replica_failures",
                  "fleet_breaker_opens", "fleet_shed_overloaded",
                  "fleet_drains", "fleet_restarts",
                  "fleet_deadline_exceeded", "serving_poisoned_batches")
MACHINE = [("HEALTHY", "DRAINING"), ("DRAINING", "DEAD"),
           ("DEAD", "RESTARTING"), ("RESTARTING", "WARMING"),
           ("WARMING", "HEALTHY")]


def _ref_factory(seed=7, prefix="fleet_t_"):
    def make():
        net = mx.gluon.nn.Dense(4, in_units=ff.IN_UNITS, prefix=prefix)
        net.initialize()
        params = net.collect_params()
        for k, v in ff.dense_params(seed).items():
            params[prefix + k].set_data(mx.nd.array(v))
        return jserving.Predictor.from_block(
            net, input_shapes={"data": (ff.IN_UNITS,)}, batch_sizes=(4,),
            warmup=False)
    return make


# the two packages' surfaces a drill needs
PKGS = {
    "port": (serving, faults, lambda seed=7: functools.partial(
        ff.dense_predictor, seed)),
    "ref": (jserving, jfaults, _ref_factory),
}


def _host(o):
    return o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)


def _reference(seed=7):
    return ff.dense_predictor(seed).predict(X1)[0].numpy()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for f in (faults, jfaults):
        f.reset()
    for w in (watchdog, jwatchdog):
        w.reset_peers()
    serving.reset_stats()
    jserving.reset_stats()
    monkeypatch.setenv("MXNET_TPU_TORCH_FAULT_HANG_CAP", "1")
    monkeypatch.setenv("MXNET_TPU_FAULT_HANG_CAP", "1")
    monkeypatch.delenv("MXNET_TPU_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("MXNET_TPU_TORCH_COMPILE_CACHE", raising=False)
    yield
    for f in (faults, jfaults):
        f.reset()
    for w in (watchdog, jwatchdog):
        w.reset_peers()


def _fleet(pkg="port", replicas=2, **kw):
    srv, _, make = PKGS[pkg]
    kw.setdefault("probe_interval_ms", 50)
    kw.setdefault("breaker_k", 2)
    kw.setdefault("breaker_cooldown_ms", 100)
    kw.setdefault("retries", 2)
    kw.setdefault("backoff_ms", 1)
    kw.setdefault("server_kw", {"batch_timeout_ms": 1.0})
    factories = kw.pop("factories", None) or make()
    return srv.Fleet(factories, replicas=replicas, **kw)


def _drill(pkg, kind, times, requests, **kw):
    """One drill on one package's fleet: ``kind`` armed ``times`` on
    replica 0, ``requests`` sequential requests, then back to HEALTHY.
    Returns (fires, answers, the victim's walk, counters)."""
    srv, flt, _ = PKGS[pkg]
    kw.setdefault("probe_interval_ms", 60000)
    with _fleet(pkg, **kw) as fleet:
        fleet.submit(X1, deadline_ms=20000).result(timeout=60)   # warm
        srv.reset_stats()
        victim = fleet.replicas()[0]
        with flt.inject(kind, times=times) as f:
            outs = [_host(fleet.submit(X1, deadline_ms=20000)
                          .result(timeout=60)[0]) for _ in range(requests)]
        assert fleet.wait_healthy(timeout=60)
        walk = [(a, b) for _, a, b, _ in victim.transitions]
        s = srv.stats()
    return f.fired, outs, walk, {k: s[k] for k in DRILL_COUNTERS}


# ---------------------------------------------------------------- basics


def test_submit_matches_single_predictor():
    """The fleet's answers of the 2-layer flash LM equal mxnet_tpu's net on
    the carried weights within 1e-5 of max|logit| (mxnet_tpu's Predictor
    cannot trace this Block symbolically, so its forward is the
    reference), and the port's own Predictor's bitwise."""
    cfg = dict(vocab=48, units=32, num_heads=2, num_layers=2, max_len=32)
    t = 16
    jnet = jzoo.transformer_lm(impl="flash", prefix="tlm_", **cfg)
    jnet.initialize(mx.initializer.Xavier())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jnet(mx.nd.array(np.zeros((1, 4)), dtype="int32"))
    values = {k: p.data().asnumpy().copy()
              for k, p in jnet.collect_params().items()}

    def make():
        tnet = tzoo.transformer_lm(impl="flash", prefix="tlm_", **cfg)
        tnet.initialize(ctx=mt.cpu())
        tnet.load_numpy_params(values)
        return serving.Predictor.from_block(
            tnet, input_shapes={"data": (t,)}, batch_sizes=(1, 2, 4),
            ctx=mt.cpu(), warmup=False)

    ids = np.random.RandomState(3).randint(0, cfg["vocab"], (4, t))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jnet(mx.nd.array(ids, dtype="int32")).asnumpy()
    own = make().predict(ids)[0].numpy()
    with _fleet(replicas=2, factories=make) as fleet:
        futs = [fleet.submit(ids[i:i + 1], deadline_ms=60000)
                for i in range(4)]
        got = np.concatenate([f.result(timeout=60)[0].numpy()
                              for f in futs])
        assert fleet.replica_states() == ["HEALTHY", "HEALTHY"]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for i in range(4):
        np.testing.assert_array_equal(
            got[i:i + 1], make().predict(ids[i:i + 1])[0].numpy())
    np.testing.assert_allclose(own, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_unknown_model_is_an_error():
    with _fleet(replicas=1) as fleet:
        with pytest.raises(MXNetError, match="serves models"):
            fleet.submit(X1, model="nope")


def test_per_model_groups_and_routing():
    with _fleet(replicas=1, factories={
            "a": functools.partial(ff.dense_predictor, 1),
            "b": functools.partial(ff.dense_predictor, 2)}) as fleet:
        assert fleet.models() == ["a", "b"]
        out_a = fleet.submit(X1, model="a", deadline_ms=10000).result(30)
        out_b = fleet.submit(X1, model="b", deadline_ms=10000).result(30)
    np.testing.assert_array_equal(out_a[0].numpy(), _reference(1))
    np.testing.assert_array_equal(out_b[0].numpy(), _reference(2))


def test_load_balances_across_replicas():
    with _fleet(replicas=2) as fleet:
        fs = [fleet.submit(X1, deadline_ms=20000) for _ in range(24)]
        for f in fs:
            f.result(timeout=30)
        counts = [len(r.latency_snapshot()) for r in fleet.replicas()]
        summary = serving.stats()["fleet_replica_latency_us"]
    assert sum(counts) == 24
    assert all(c > 0 for c in counts), counts
    assert "default/0" in summary and "default/1" in summary


# ---------------------------------------------------- retries + deadlines


def test_retry_lands_on_a_different_replica():
    with _fleet(replicas=2, breaker_k=5) as fleet:
        with faults.inject("replica_crash", times=1) as f:
            out = fleet.submit(X1, deadline_ms=10000).result(timeout=30)
    assert f.fired == 1
    np.testing.assert_array_equal(out[0].numpy(), _reference())
    s = serving.stats()
    assert s["fleet_retries"] >= 1 and s["fleet_replica_failures"] >= 1
    assert "default/1" in s["fleet_replica_latency_us"]


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_admission_fail_fast_on_spent_budget(pkg):
    srv = PKGS[pkg][0]
    with _fleet(pkg, replicas=1) as fleet:
        for budget in (0, -5.0):
            fut = fleet.submit(X1, deadline_ms=budget)
            with pytest.raises(Exception) as ei:
                fut.result(timeout=5)
            assert type(ei.value).__name__ == "DeadlineExceeded"
    assert srv.stats()["fleet_deadline_exceeded"] == 2


def test_expired_request_is_never_retried():
    with _fleet(replicas=1, breaker_k=50, retries=50, backoff_ms=200,
                backoff_cap_ms=200) as fleet:
        fleet.submit(X1, deadline_ms=10000).result(timeout=30)
        with faults.inject("replica_crash", times=None):
            t0 = time.monotonic()
            fut = fleet.submit(X1, deadline_ms=250)
            with pytest.raises((DeadlineExceeded, faults.ReplicaCrash,
                                serving.FleetOverloaded)):
                fut.result(timeout=10)
            elapsed = time.monotonic() - t0
        assert elapsed < 3.0, elapsed
        retries_at_resolve = serving.stats()["fleet_retries"]
        time.sleep(0.5)
        assert serving.stats()["fleet_retries"] == retries_at_resolve <= 2


def test_backoff_is_capped_and_jittered():
    fleet_mod._jitter.seed(1234)
    delays = [fleet_mod._backoff_delay(0.1, 1.0, a) for a in range(1, 9)]
    for attempt, d in enumerate(delays, start=1):
        ceiling = min(0.1 * 2 ** (attempt - 1), 1.0)
        assert ceiling / 2 - 1e-9 <= d <= ceiling + 1e-9
    assert delays[:3] != [0.1, 0.2, 0.4]


def test_hedge_counts_when_primary_is_wedged():
    """Replica 0 (chosen first: ties break by rid) hangs past the hedge
    delay; the hedge on replica 1 answers."""
    with _fleet(replicas=2, hedge_ms=20.0, breaker_k=50,
                probe_interval_ms=60000) as fleet:
        for _ in range(4):
            fleet.submit(X1, deadline_ms=20000).result(timeout=30)
        serving.reset_stats()
        with faults.inject("replica_hang", times=1):
            res = fleet.submit(X1, deadline_ms=10000).result(timeout=30)
    np.testing.assert_array_equal(res[0].numpy(), _reference())
    s = serving.stats()
    assert s["fleet_hedges"] >= 1 and s["fleet_hedge_wins"] >= 1


# ------------------------------------------- drills, held to mxnet_tpu


@pytest.mark.parametrize("kind,times,requests,kw", [
    ("replica_crash", 2, 4, {}),
    ("replica_nan_storm", 2, 4, {}),
    ("replica_hang", 1, 2, {"breaker_k": 1}),
])
def test_drill_walk_and_counters_match_mxnet_tpu(kind, times, requests, kw):
    """The same drill on both fleets: every request answered (the victim's
    failures retried on its sibling), the victim walks the whole machine,
    and the counters agree."""
    got = _drill("port", kind, times, requests, **kw)
    want = _drill("ref", kind, times, requests, **kw)
    assert got[0] == want[0] == times
    ref = _reference()
    for o in got[1]:
        np.testing.assert_array_equal(o, ref)
    for o in want[1]:
        np.testing.assert_allclose(o, ref, rtol=1e-6, atol=1e-6)
    assert got[2] == want[2], (got[2], want[2])
    assert got[2][:1] == [("RESTARTING", "HEALTHY")]
    assert got[2][1:] == MACHINE
    assert got[3] == want[3], (got[3], want[3])
    assert got[3]["fleet_breaker_opens"] == 1
    assert got[3]["fleet_retries"] == times


def test_breaker_opens_drains_restarts_readmits():
    with _fleet(replicas=2) as fleet:
        victim = fleet.replicas()[0]
        with faults.inject("replica_crash", times=4) as f:
            outs = [fleet.submit(X1, deadline_ms=10000).result(timeout=30)
                    for _ in range(4)]
        assert all(np.array_equal(o[0].numpy(), _reference()) for o in outs)
        assert f.fired >= 2
        assert fleet.wait_healthy(timeout=30)
        seq = [(a, b) for _, a, b, _ in victim.transitions]
        for edge in MACHINE:
            assert edge in seq, (edge, seq)
    s = serving.stats()
    assert s["fleet_breaker_opens"] >= 1 and s["fleet_drains"] >= 1
    assert s["fleet_restarts"] >= 1 and s["fleet_half_open_probes"] >= 1


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_all_breakers_open_sheds_structured_then_recovers(pkg):
    srv, flt, _ = PKGS[pkg]
    with _fleet(pkg, replicas=1, breaker_k=1, retries=1,
                breaker_cooldown_ms=5000) as fleet:
        fleet.submit(X1, deadline_ms=10000).result(timeout=60)
        with flt.inject("replica_crash", times=2):
            with pytest.raises(Exception) as first:
                fleet.submit(X1, deadline_ms=5000).result(timeout=30)
            with pytest.raises(Exception) as ei:
                fleet.submit(X1, deadline_ms=5000).result(timeout=30)
        assert type(first.value).__name__ in ("FleetOverloaded",
                                              "ReplicaCrash")
        err = ei.value
        assert type(err).__name__ == "FleetOverloaded"
        assert (err.model, err.total) == ("default", 1)
        assert err.open_breakers + err.unhealthy >= 1
        assert fleet.wait_healthy(timeout=30)
        fleet.submit(X1, deadline_ms=10000).result(timeout=30)
    assert srv.stats()["fleet_shed_overloaded"] >= 1


def test_probe_failure_restarts_a_hung_replica():
    """No traffic at all: the supervisor's own probes find the wedged
    replica and recycle it."""
    with _fleet(replicas=2, probe_interval_ms=40, breaker_k=50) as fleet:
        fleet.submit(X1, deadline_ms=10000).result(timeout=30)
        with faults.inject("replica_hang", times=2):
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and \
                    serving.stats()["fleet_restarts"] < 1:
                time.sleep(0.05)
        s = serving.stats()
        assert s["fleet_probe_failures"] >= 1 and s["fleet_restarts"] >= 1
        assert fleet.wait_healthy(timeout=30)


def test_factory_failure_tears_down_built_replicas():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("factory boom")
        return ff.dense_predictor()

    before = {t.ident for t in threading.enumerate()}
    with pytest.raises(RuntimeError, match="factory boom"):
        serving.Fleet(flaky, replicas=2,
                      server_kw={"batch_timeout_ms": 1.0})
    time.sleep(0.3)
    leaked = [t for t in threading.enumerate()
              if t.ident not in before and t.is_alive()
              and t.name.startswith("mxnet-torch-serving")]
    assert not leaked, leaked


def test_operator_fail_replica_walks_the_machine():
    with _fleet(replicas=2) as fleet:
        victim = fleet.replicas()[1]
        assert fleet.fail_replica(victim.rid) is True
        assert fleet.fail_replica(victim.rid) in (False, True)
        assert fleet.wait_healthy(timeout=30)
        assert victim.generation >= 2
    s = serving.stats()
    assert s["fleet_drains"] >= 1 and s["fleet_restarts"] >= 1


# ----------------------------------------------------- zero lost futures


def _hammer(pkg):
    """8 client threads on 4 replicas, two kill waves mid-load; returns
    (results, the two victims' walks, drains)."""
    srv = PKGS[pkg][0]
    results = {"ok": 0, "err": 0, "lost": 0, "bad": 0}
    lock = threading.Lock()
    ref = _reference()
    with _fleet(pkg, replicas=4, breaker_k=2, retries=3) as fleet:
        for _ in range(8):
            fleet.submit(X1, deadline_ms=20000).result(timeout=60)
        srv.reset_stats()
        stop = threading.Event()

        def client():
            while not stop.is_set():
                fut = fleet.submit(X1, deadline_ms=2000)
                try:
                    out = _host(fut.result(timeout=30)[0])
                    ok = np.allclose(out, ref, rtol=1e-6, atol=1e-6)
                    with lock:
                        results["ok" if ok else "bad"] += 1
                except _futures.TimeoutError:
                    with lock:
                        results["lost"] += 1
                except Exception:
                    with lock:
                        results["err"] += 1

        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        fleet.fail_replica(0, reason="hammer")
        time.sleep(0.2)
        fleet.fail_replica(1, reason="hammer")
        time.sleep(0.4)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert fleet.wait_healthy(timeout=60)
        walks = [[(a, b) for _, a, b, _ in r.transitions][1:6]
                 for r in fleet.replicas()[:2]]
        drains = srv.stats()["fleet_drains"]
    return results, walks, drains


def test_zero_lost_futures_under_kill_hammer():
    got, got_walks, got_drains = _hammer("port")
    want, want_walks, want_drains = _hammer("ref")
    for res in (got, want):
        assert res["lost"] == 0 and res["bad"] == 0, res
        assert res["ok"] > 0, res
    assert got_walks == want_walks == [MACHINE, MACHINE]
    assert got_drains == want_drains == 2


def test_answered_results_are_not_pinned():
    """Once the client drops an answered request, nothing of the fleet
    holds its result: not the deadline timer (up to the deadline's end),
    not the replica's idle worker (its last batch)."""
    import gc
    import weakref

    with _fleet(replicas=2, probe_interval_ms=60000) as fleet:
        fut = fleet.submit(X1, deadline_ms=600000)
        ref = weakref.ref(fut.result(timeout=30)[0])
        del fut
        gc.collect()
        assert ref() is None


def test_close_resolves_outstanding_with_fleet_closed():
    fleet = _fleet(replicas=1, breaker_k=50, probe_interval_ms=5000)
    fleet.submit(X1, deadline_ms=10000).result(timeout=30)
    with faults.inject("replica_hang", times=1):
        fut = fleet.submit(X1)
        time.sleep(0.05)
        fleet.close()
    with pytest.raises((serving.FleetClosed, ServerClosed,
                        faults.FaultInjected, watchdog.StallError)):
        fut.result(timeout=10)
    with pytest.raises((serving.FleetClosed, serving.FleetOverloaded)):
        fleet.submit(X1).result(timeout=5)


# ------------------------------------------------------- kvstore wiring


def test_kvstore_membership_excise_wiring():
    """A draining replica's rid is marked dead in the watchdog's peer
    bookkeeping; re-admission clears exactly that rank through the
    store's ``excise_dead_peers``."""
    kv = mt.kv.create("local")
    watchdog.mark_peer_dead(7)       # an unrelated dead rank stays dead
    with _fleet(replicas=2, kvstore=kv) as fleet:
        fleet.fail_replica(1, reason="test")
        assert fleet.wait_healthy(timeout=30)
        assert watchdog.dead_peers() == [7]
    assert kv.excise_dead_peers() == [7] and watchdog.dead_peers() == []


def test_restart_warm_starts_from_aot_cache(monkeypatch, tmp_path):
    """No AOT cache in the port (ROADMAP Queue 1 item 4): asking for one
    raises at the first replica's build, and a restart captures again."""
    monkeypatch.setenv("MXNET_TPU_TORCH_COMPILE_CACHE", str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 4"):
        _fleet(replicas=1)


# ------------------------------------------------------------ processes


def test_process_mode_survives_a_real_process_kill():
    """One spawned child replica on the CPU: killed with SIGKILL, its
    in-flight request terminates, the supervisor sees the dead process,
    restarts it (a new pid) and it answers again."""
    with _fleet(replicas=1, mode="process", probe_interval_ms=50,
                retries=0) as fleet:
        out = fleet.submit(X1, deadline_ms=60000).result(timeout=120)
        np.testing.assert_array_equal(out[0].numpy(), _reference())
        r = fleet.replicas()[0]
        pid = r.pid
        os.kill(pid, 9)
        fut = fleet.submit(X1, deadline_ms=60000)
        try:
            fut.result(timeout=120)
        except Exception as e:
            assert isinstance(e, (ServerClosed, serving.FleetOverloaded))
        deadline = time.monotonic() + 120
        while r.generation < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert fleet.wait_healthy(timeout=120)
        assert r.pid not in (None, pid)
        out = fleet.submit(X1, deadline_ms=60000).result(timeout=120)
        np.testing.assert_array_equal(out[0].numpy(), _reference())
        seq = [(a, b) for _, a, b, _ in r.transitions]
        assert seq[1:6] == MACHINE
    assert serving.stats()["fleet_restarts"] >= 1


# -------------------------------------------------------------- scaling


def test_scale_down_never_drains_the_last_replica():
    with _fleet(replicas=1) as fleet:
        assert fleet.scale_to(1) == 1
        assert fleet.supervisor.remove_replica("default") is None


def test_scale_up_admits_probed_warm_replicas():
    with _fleet(replicas=1) as fleet:
        assert fleet.scale_to(3) == 3
        assert fleet.replica_states() == ["HEALTHY"] * 3
        assert serving.stats()["fleet_scale_up"] == 2
        out = fleet.submit(X1, deadline_ms=10000).result(timeout=30)
        np.testing.assert_array_equal(out[0].numpy(), _reference())
        assert fleet.scale_to(2) == 2
        deadline = time.monotonic() + 30
        while len(fleet.replicas()) > 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fleet.replica_states() == ["HEALTHY"] * 2
    assert serving.stats()["fleet_scale_down"] == 1


# ------------------------------------------------------ dtype variants


def test_int8_variant_served_beside_fp32_under_the_sentinel(monkeypatch):
    """A {fp32, int8} variant group of a ResNet-18 Symbol (32x32 images):
    each variant answers as its own Predictor does, bitwise, and a NaN
    storm on the int8 replica is caught by the sentinel on its dequantized
    outputs, retried on nothing else (its group has one member) and shed,
    while the fp32 variant keeps serving; the int8 replica is recycled."""
    from mxnet_tpu_torch import symbol as tsym
    from mxnet_tpu_torch.contrib import quantization as tq
    from mxnet_tpu_torch.gluon import block as tblock
    from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

    tblock._BlockScope._global_counter.clear()
    tsym.reset_name_counters()
    rng = np.random.RandomState(16)
    sym = tvision.resnet18_v1(classes=10)(tsym.var("data"))
    shapes = dict(zip(sym.list_arguments(),
                      sym.infer_shape(data=(1, 3, 32, 32))[0]))
    params = {}
    for name in sym.list_arguments():
        if name == "data":
            continue
        shape = shapes[name]
        if name.endswith("gamma"):
            v = rng.rand(*shape) + 0.5
        elif name.endswith(("beta", "bias")):
            v = rng.randn(*shape) * 0.1
        else:
            v = rng.randn(*shape) * (2.0 / np.prod(shape[1:])) ** 0.5
        params[f"arg:{name}"] = v.astype(np.float32)
    for name, shape in zip(sym.list_auxiliary_states(),
                           sym.infer_shape(data=(1, 3, 32, 32))[2]):
        v = rng.rand(*shape) + 0.5 if name.endswith("var") else \
            rng.randn(*shape) * 0.1
        params[f"aux:{name}"] = v.astype(np.float32)
    calib = rng.rand(8, 3, 32, 32).astype(np.float32)
    table = serving.Predictor(
        sym, params, ctx=mt.cpu(), input_shapes={"data": (3, 32, 32)},
        batch_sizes=(4,), warmup=False, quantize="int8",
        calib_data=mt.io.NDArrayIter(calib, batch_size=4),
        calib_mode="naive").calibration_table
    assert isinstance(table, tq.CalibrationTable)

    def make(quant):
        return serving.Predictor(
            sym, params, ctx=mt.cpu(), input_shapes={"data": (3, 32, 32)},
            batch_sizes=(4,), warmup=False, quantize=quant,
            calib_table=table if quant else None)

    x = rng.rand(2, 3, 32, 32).astype(np.float32)
    want = {v: make(q).predict(x)[0].numpy()
            for v, q in (("fp32", None), ("int8", "int8"))}
    assert not np.array_equal(want["fp32"], want["int8"])
    with _fleet(replicas=1, breaker_k=1, retries=0, probe_interval_ms=60000,
                factories={"r18": {"fp32": functools.partial(make, None),
                                   "int8": functools.partial(make, "int8")}}
                ) as fleet:
        assert fleet.variants("r18") == ["fp32", "int8"]
        for v in ("fp32", "int8"):
            out = fleet.submit(x, model="r18", variant=v,
                               deadline_ms=60000).result(timeout=60)
            np.testing.assert_array_equal(out[0].numpy(), want[v])
        int8_rid = fleet.replicas("r18", "int8")[0].rid
        monkeypatch.setenv("MXNET_TPU_TORCH_FAULT_REPLICA", str(int8_rid))
        with faults.inject("replica_nan_storm", times=1) as f:
            with pytest.raises(Exception) as ei:
                fleet.submit(x, model="r18", variant="int8",
                             deadline_ms=60000).result(timeout=60)
            out = fleet.submit(x, model="r18", variant="fp32",
                               deadline_ms=60000).result(timeout=60)
        assert f.fired == 1
        assert "NumericHealthError" in type(ei.value).__name__
        assert "int8 executable" in str(ei.value)
        np.testing.assert_array_equal(out[0].numpy(), want["fp32"])
        assert fleet.wait_healthy(timeout=60)
        out = fleet.submit(x, model="r18", variant="int8",
                           deadline_ms=60000).result(timeout=60)
        np.testing.assert_array_equal(out[0].numpy(), want["int8"])
    assert serving.stats()["serving_poisoned_batches"] == 1


# ------------------------------------------------------ StreamRouter


def test_stream_router_reroutes_on_replica_death():
    """Two fp32 decode replicas; ``decode_replica_death`` kills one engine
    mid-stream: each of its streams resumes on the survivor (prompt plus
    the tokens already streamed prefilled again) and ends with exactly
    the unfaulted tokens, which equal mxnet_tpu's greedy decode."""
    vocab, max_len = 40, 48
    geom = dict(page_size=4, num_pages=16, max_seqs=2)
    mx.random.seed(7)
    jnet = jzoo.transformer_lm(vocab=vocab, units=24, num_heads=2,
                               num_layers=1, max_len=max_len, prefix="tlm_")
    jnet.initialize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jnet(mx.nd.array(np.zeros((1, 8), np.int32), dtype="int32"))
    values = {n: p.data().asnumpy().copy()
              for n, p in jnet.collect_params().items()}

    def make():
        tnet = tzoo.transformer_lm(vocab=vocab, units=24, num_heads=2,
                                   num_layers=1, max_len=max_len,
                                   prefix="tlm_")
        tnet.initialize(ctx=mt.cpu())
        tnet.load_numpy_params(values)
        return serving.DecodePredictor(tnet, ctx=mt.cpu(),
                                       prefill_buckets=(8, 16), **geom)

    prompts = ([3, 17, 5, 29, 11], [4, 8, 15, 16, 23, 2])
    jpred = jserving.DecodePredictor(jnet, prefill_buckets=(8, 16), **geom)
    want = [jpred.greedy_decode(p, 12) for p in prompts]
    router = serving.StreamRouter(make, replicas=2, ttft_slo_ms=60000)
    try:
        # the engine loop's 4th pass dies: both streams are live by then
        with faults.inject("decode_replica_death", at_step=3, times=1) as f:
            streams = [router.submit_stream(p, 12) for p in prompts]
            got = [s.result(timeout=60) for s in streams]
        assert f.fired == 1
        assert got == want
        assert serving.stats()["decode_reroutes"] >= 1
        assert router.live_replicas == 1
        assert all(b.predictor.pool.in_use == 0 for b in router.replicas)
        assert router.revive() == 1 and router.live_replicas == 2
        s = router.submit_stream(prompts[0], 12)
        assert s.result(timeout=60) == want[0]
    finally:
        router.close()

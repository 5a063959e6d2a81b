"""The port's fleet operator (``mxnet_tpu_torch/serving/operator.py``) and
``Predictor.swap_params`` against ``mxnet_tpu``'s, on the CPU, after
``tests/test_operator.py``.

Fleets serve a 1-bucket Dense(4) Predictor (weights from numpy seeds, the
same in both packages). Every gate that reads a clock is driven through an
injected fault (``canary_slo_regression``, ``slo_burn``,
``autoscale_flap``) or given a window no scheduler stall can cross, never a
tight threshold on the wall clock. ``swap_params`` is also held on the
2-layer flash LM (the served program's output moves with the swap and
equals a fresh Predictor's on the new weights, bitwise) and on an int8
Predictor (only its bound, quantized cells swap).
"""
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import serving as jserving  # noqa: E402
from mxnet_tpu.observability import alerts as jalerts  # noqa: E402
from mxnet_tpu.observability import flight as jflight  # noqa: E402
from mxnet_tpu.observability import trace as jtrace  # noqa: E402
from mxnet_tpu.resilience import faults as jfaults  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import serving  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import transformer as tzoo  # noqa: E402
from mxnet_tpu_torch.observability import alerts, flight, trace  # noqa
from mxnet_tpu_torch.resilience import faults, watchdog  # noqa: E402

import _torch_fleet_factories as ff  # noqa: E402

X1 = np.ones((1, ff.IN_UNITS), np.float32)
BATCH = np.array([[1.0, 0.5, -1.0], [0.2, -0.3, 2.0]], np.float32)
PREFIX = "fleet_t_"


def _ref_factory(seed=7, prefix=PREFIX):
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


def _port_params(seed):
    return {f"arg:{PREFIX}{k}": torch.from_numpy(v)
            for k, v in ff.dense_params(seed).items()}


def _ref_params(seed):
    return {f"arg:{PREFIX}{k}": mx.nd.array(v)
            for k, v in ff.dense_params(seed).items()}


PKGS = {
    "port": dict(serving=serving, faults=faults, alerts=alerts,
                 flight=flight, trace=trace, params=_port_params,
                 factory=lambda seed=7: lambda: ff.dense_predictor(seed)),
    "ref": dict(serving=jserving, faults=jfaults, alerts=jalerts,
                flight=jflight, trace=jtrace, params=_ref_params,
                factory=_ref_factory),
}


def _host(o):
    if isinstance(o, torch.Tensor):
        return o.numpy()
    return o.asnumpy() if hasattr(o, "asnumpy") else np.asarray(o)


def _expected(seed, x):
    return ff.dense_predictor(seed).predict(x)[0].numpy()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for lib in PKGS.values():
        lib["faults"].reset()
        lib["serving"].reset_stats()
    watchdog.reset_peers()
    yield
    for lib in PKGS.values():
        lib["faults"].reset()


def _fleet(pkg="port", replicas=2, seed=7, **kw):
    lib = PKGS[pkg]
    kw.setdefault("probe_interval_ms", 50)
    kw.setdefault("breaker_k", 2)
    kw.setdefault("breaker_cooldown_ms", 100)
    kw.setdefault("retries", 2)
    kw.setdefault("backoff_ms", 1)
    kw.setdefault("server_kw", {"batch_timeout_ms": 1.0})
    return lib["serving"].Fleet(lib["factory"](seed), replicas=replicas,
                                **kw)


# ------------------------------------------------------------- autoscaler


def test_autoscaler_validates_hysteresis_thresholds():
    with _fleet(replicas=1) as fleet:
        with pytest.raises(MXNetError, match="hysteresis"):
            serving.Autoscaler(fleet, up_queue=2.0, down_queue=2.0)


def test_autoscaler_hold_is_a_recorded_decision():
    with _fleet(replicas=2) as fleet:
        assert fleet.wait_healthy(timeout=30)
        asc = serving.Autoscaler(fleet, min_replicas=2, max_replicas=4,
                                 up_queue=8.0, down_queue=1.0)
        mark = flight.last_seq()
        (decision,) = asc.evaluate()
        assert decision["action"] == "hold"
        assert serving.stats()["fleet_scale_hold"] == 1
        evs = flight.events("operator", since_seq=mark)
        assert len(evs) == 1 and evs[0]["decide"] == "hold"


def _flap(pkg):
    lib = PKGS[pkg]
    with _fleet(pkg, replicas=2) as fleet:
        assert fleet.wait_healthy(timeout=30)
        asc = lib["serving"].Autoscaler(
            fleet, min_replicas=1, max_replicas=8, up_queue=4.0,
            down_queue=1.0, cooldown_s=3600.0)
        with lib["faults"].inject("autoscale_flap", times=None) as f:
            decisions = [(d["action"], d["from"], d["to"],
                          d["queue_per_replica"])
                         for _ in range(8) for d in asc.evaluate()]
        assert f.fired == 8
        assert fleet.wait_healthy(timeout=30)
        return decisions, fleet.replica_count()


def test_autoscaler_cooldown_bounds_a_flapping_signal():
    """A square-wave load signal causes at most one scale event per
    cooldown, the same decisions in both packages."""
    got, want = _flap("port"), _flap("ref")
    assert got == want
    actions = [d[0] for d in got[0]]
    assert actions.count("scale_up") == 1 and "scale_down" not in actions
    assert got[1] == 3


def _burn_scale(pkg):
    lib = PKGS[pkg]
    al = lib["alerts"]
    al.reset()
    prev = al.set_enabled(False)     # only the synthetic clock evaluates
    try:
        with _fleet(pkg, replicas=2) as fleet:
            assert fleet.wait_healthy(timeout=30)
            for _ in range(4):
                fleet.submit(X1, deadline_ms=10000).result(timeout=30)
            t = 1000.0
            al.evaluate(now=t, force=True)
            with lib["faults"].inject("slo_burn", times=None):
                for _ in range(2):
                    t += 30.0
                    al.evaluate(now=t, force=True)
            (inc,) = [i for i in al.open_incidents()
                      if i["rule"] == "slo_deadline_burn"]
            assert any(e.get("kind") == "fault" for e in inc["flight"])
            asc = lib["serving"].Autoscaler(
                fleet, min_replicas=2, max_replicas=4, up_queue=8.0,
                down_queue=1.0, cooldown_s=0.0)
            (decision,) = asc.evaluate()
            return ({k: decision[k] for k in ("action", "from", "to",
                                               "slo_burn")},
                    fleet.replica_states())
    finally:
        al.set_enabled(prev)
        al.reset()


def test_autoscaler_scales_up_on_open_slo_burn_incident():
    got, want = _burn_scale("port"), _burn_scale("ref")
    assert got == want
    assert got[0] == {"action": "scale_up", "from": 2, "to": 3,
                      "slo_burn": True}
    assert got[1] == ["HEALTHY"] * 3


def test_autoscaler_background_loop_starts_and_stops():
    with _fleet(replicas=2) as fleet:
        assert fleet.wait_healthy(timeout=30)
        asc = serving.Autoscaler(fleet, min_replicas=2, max_replicas=4,
                                 up_queue=8.0, down_queue=1.0,
                                 interval_s=0.05)
        asc.start()
        assert asc.start() is asc
        import time
        deadline = time.monotonic() + 30
        while (serving.stats()["fleet_scale_hold"] < 2
               and time.monotonic() < deadline):
            time.sleep(0.02)
        asc.stop()
        assert serving.stats()["fleet_scale_hold"] >= 2
        assert fleet.replica_count() == 2


# ------------------------------------------------------------ weight swap


def test_swap_params_validates_before_flipping_anything():
    pred = ff.dense_predictor()
    base = pred.predict(X1)[0].numpy()
    good = _port_params(11)
    name = next(iter(good))
    with pytest.raises(MXNetError, match="not a bound"):
        pred.swap_params({"arg:nosuch_weight": good[name], **good})
    with pytest.raises(MXNetError, match="new Predictor"):
        pred.swap_params({**good, name: torch.zeros(2, 2)})
    with pytest.raises(MXNetError, match="new Predictor"):
        pred.swap_params({name: good[name].double()})
    np.testing.assert_array_equal(pred.predict(X1)[0].numpy(), base)


def test_swap_params_round_trips_through_the_prev_snapshot():
    for pkg in ("port", "ref"):
        lib = PKGS[pkg]
        pred = lib["factory"](7)()
        base = _host(pred.predict(X1)[0])
        prev = pred.swap_params(lib["params"](11))
        swapped = _host(pred.predict(X1)[0])
        assert not np.array_equal(swapped, base)
        np.testing.assert_allclose(swapped, _expected(11, X1), rtol=1e-6,
                                   atol=1e-6)
        assert set(prev) == set(lib["params"](11))
        pred.swap_params(prev)
        np.testing.assert_array_equal(_host(pred.predict(X1)[0]), base)


def test_swap_params_snapshot_is_a_clone():
    """The prior values must not be views of the cells: a second swap
    would otherwise hand back the new values on rollback."""
    pred = ff.dense_predictor()
    base = pred.predict(X1)[0].numpy()
    prev = pred.swap_params(_port_params(11))
    pred.swap_params(_port_params(13))
    pred.swap_params(prev)
    np.testing.assert_array_equal(pred.predict(X1)[0].numpy(), base)


def test_swap_params_is_atomic_under_concurrent_predict():
    pred = ff.dense_predictor(7)
    a, b = _port_params(7), _port_params(11)
    out_a, out_b = _expected(7, X1), _expected(11, X1)
    stop = threading.Event()
    torn = []

    def reader():
        while not stop.is_set():
            got = pred.predict(X1)[0].numpy()
            if not (np.array_equal(got, out_a)
                    or np.array_equal(got, out_b)):
                torn.append(got)
                return

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    for _ in range(50):
        pred.swap_params(b)
        pred.swap_params(a)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not torn


def test_swap_params_moves_the_served_lm_program():
    """2-layer flash LM: after the swap the bucket program serves the new
    weights (bitwise a fresh Predictor's on them); the caller's tensors
    are never written."""
    cfg = dict(vocab=48, units=32, num_heads=2, num_layers=2, max_len=32)

    def lm(seed):
        net = tzoo.transformer_lm(impl="flash", prefix="tlm_", **cfg)
        net.initialize(mt.init.Xavier(), ctx=mt.cpu(),
                       generator=torch.Generator().manual_seed(seed))
        return net

    def pred_of(net):
        return serving.Predictor.from_block(
            net, input_shapes={"data": (16,)}, batch_sizes=(2,),
            ctx=mt.cpu(), warmup=False)

    ids = np.random.RandomState(1).randint(0, cfg["vocab"], (2, 16))
    old, new = lm(0), lm(1)
    pred = pred_of(old)
    before = pred.predict(ids)[0].numpy()
    cand = {k: v.detach().clone() for k, v in new.collect_params().items()}
    keep = {k: v.clone() for k, v in cand.items()}
    prev = pred.swap_params(cand)
    after = pred.predict(ids)[0].numpy()
    assert not np.array_equal(after, before)
    np.testing.assert_array_equal(after, pred_of(new).predict(ids)[0]
                                  .numpy())
    for k in cand:
        assert torch.equal(cand[k], keep[k])
    pred.swap_params(prev)
    np.testing.assert_array_equal(pred.predict(ids)[0].numpy(), before)


def test_swap_params_on_an_int8_predictor_swaps_bound_cells_only():
    from mxnet_tpu_torch import symbol as tsym

    data = tsym.Variable("data")
    s = tsym.FullyConnected(data, num_hidden=4, name="sw_fc")
    rng = np.random.RandomState(0)
    params = {"sw_fc_weight": rng.randn(4, 3).astype(np.float32),
              "sw_fc_bias": rng.randn(4).astype(np.float32)}
    pred = serving.Predictor(
        s, params, ctx=mt.cpu(), input_shapes={"data": (3,)},
        batch_sizes=(2,), warmup=False, quantize="int8",
        calib_data=mt.io.NDArrayIter(rng.rand(4, 3).astype(np.float32),
                                     batch_size=2), calib_mode="naive")
    assert pred.quant_tag == " (int8 executable)"
    bound = {k for kind, k in pred._bound_cells()}
    assert "sw_fc_weight" not in bound
    with pytest.raises(MXNetError, match="not a bound"):
        pred.swap_params({"sw_fc_weight": params["sw_fc_weight"]})
    x = rng.rand(2, 3).astype(np.float32)
    base = pred.predict(x)[0].numpy()
    name = sorted(bound)[0]
    kind = "aux" if ("aux", name) in pred._bound_cells() else "arg"
    cell = pred._bound_cells()[(kind, name)]
    prev = pred.swap_params({f"{kind}:{name}": torch.zeros_like(cell)})
    pred.swap_params(prev)
    np.testing.assert_array_equal(pred.predict(x)[0].numpy(), base)


# --------------------------------------------------------------- rollouts


def _promote(pkg):
    lib = PKGS[pkg]
    with _fleet(pkg, replicas=3) as fleet:
        assert fleet.wait_healthy(timeout=30)
        base = _host(fleet.submit(X1, deadline_ms=10000)
                     .result(timeout=30)[0])
        rm = lib["serving"].RolloutManager(fleet, eval_batch=BATCH,
                                           canary_calls=4,
                                           max_latency_x=1e6)
        mark = lib["flight"].last_seq()
        res = rm.rollout_weights(lib["params"](11),
                                 reference=[_expected(11, BATCH)])
        outs = [_host(r.predictor.predict(X1)[0]) for r in fleet.replicas()]
        out = _host(fleet.submit(X1, deadline_ms=10000)
                    .result(timeout=30)[0])
        evs = [e["decide"] for e in lib["flight"].events(
            "operator", since_seq=mark)]
    return (res["action"], res["agreement"], evs,
            lib["serving"].stats()["rollout_promotions"]), base, outs, out


def test_rollout_weights_promotes_fleet_wide():
    got, base, outs, out = _promote("port")
    want, *_ = _promote("ref")
    assert got == want == ("promote", 1.0, ["promote"], 1)
    for o in outs + [out]:
        np.testing.assert_array_equal(o, _expected(11, X1))
    assert not np.array_equal(out, base)


def _bad_weights(pkg):
    lib = PKGS[pkg]
    tr = lib["trace"]
    prev = tr.set_enabled(True)
    tr.clear()
    try:
        with _fleet(pkg, replicas=2) as fleet:
            assert fleet.wait_healthy(timeout=30)
            base = _host(fleet.submit(X1, deadline_ms=10000)
                         .result(timeout=30)[0])
            rm = lib["serving"].RolloutManager(fleet, eval_batch=BATCH,
                                               canary_calls=4)
            results = {"ok": 0, "err": 0, "bad": 0}
            stop = threading.Event()

            def client():
                while not stop.is_set():
                    try:
                        o = _host(fleet.submit(
                            X1, deadline_ms=10000).result(timeout=30)[0])
                        results["ok" if np.array_equal(o, base)
                                else "bad"] += 1
                    except Exception:
                        results["err"] += 1

            t = threading.Thread(target=client, daemon=True)
            t.start()
            try:
                with lib["faults"].inject("rollout_bad_weights") as f:
                    res = rm.rollout_weights(lib["params"](7))
            finally:
                stop.set()
                t.join(timeout=30)
            after = _host(fleet.submit(X1, deadline_ms=10000)
                          .result(timeout=30)[0])
            (root,) = tr.roots(("rollout.weights",))
            kids = sorted({s["name"]
                           for s in tr.spans(trace_id=root["trace"])})
        s = lib["serving"].stats()
        return (f.fired, res["action"], res["gate"], results["err"],
                results["bad"], s["rollout_rollbacks"],
                s["rollout_promotions"], root["attrs"]["outcome"], kids,
                bool(np.array_equal(after, base)))
    finally:
        tr.set_enabled(prev)


def test_rollout_bad_weights_rolls_back_with_zero_client_errors():
    got, want = _bad_weights("port"), _bad_weights("ref")
    assert got == want
    assert got[:8] == (1, "rollback", "health", 0, 0, 1, 0, "rollback")
    assert {"rollout.canary", "rollout.gate.health",
            "rollout.rollback", "rollout.weights"} <= set(got[8])
    assert got[9]


def _slo_regression(pkg, monkeypatch):
    lib = PKGS[pkg]
    # 1e6 x each canary sample: far past any scheduler stall on the
    # baseline window
    monkeypatch.setenv("MXNET_TPU_TORCH_FAULT_CANARY_SLO_X", "1e6")
    monkeypatch.setenv("MXNET_TPU_FAULT_CANARY_SLO_X", "1e6")
    with _fleet(pkg, replicas=2) as fleet:
        assert fleet.wait_healthy(timeout=30)
        base = _host(fleet.submit(X1, deadline_ms=10000)
                     .result(timeout=30)[0])
        rm = lib["serving"].RolloutManager(fleet, eval_batch=BATCH,
                                           canary_calls=4,
                                           max_latency_x=3.0)
        with lib["faults"].inject("canary_slo_regression", times=None) as f:
            res = rm.rollout_weights(lib["params"](7))
        out = _host(fleet.submit(X1, deadline_ms=10000)
                    .result(timeout=30)[0])
    return f.fired, res["action"], res["gate"], bool(np.array_equal(out,
                                                                    base))


def test_rollout_canary_slo_regression_rolls_back(monkeypatch):
    got = _slo_regression("port", monkeypatch)
    want = _slo_regression("ref", monkeypatch)
    assert got == want == (4, "rollback", "latency", True)


def test_rollout_accuracy_gate_rejects_a_behavior_shift():
    for pkg in ("port", "ref"):
        lib = PKGS[pkg]
        with _fleet(pkg, replicas=2) as fleet:
            assert fleet.wait_healthy(timeout=30)
            rm = lib["serving"].RolloutManager(
                fleet, eval_batch=BATCH, canary_calls=2,
                min_agreement=1.01)
            res = rm.rollout_weights(lib["params"](11))
            assert (res["action"], res["gate"]) == ("rollback", "accuracy")
            out = _host(fleet.submit(X1, deadline_ms=10000)
                        .result(timeout=30)[0])
            np.testing.assert_allclose(out, _expected(7, X1), rtol=1e-6,
                                       atol=1e-6)


def test_rollout_swap_validation_rolls_back():
    with _fleet(replicas=2) as fleet:
        assert fleet.wait_healthy(timeout=30)
        rm = serving.RolloutManager(fleet, eval_batch=BATCH,
                                    canary_calls=2)
        res = rm.rollout_weights({"arg:nosuch": torch.zeros(2)})
        assert (res["action"], res["gate"]) == ("rollback",
                                                "swap_validation")


def test_rollout_schedule_canaries_the_autotune_table(tmp_path):
    """The autotune tables are not ported: the schedule rollout raises
    naming ROADMAP Queue 1 item 13."""
    with _fleet(replicas=1) as fleet:
        rm = serving.RolloutManager(fleet, eval_batch=BATCH)
        with pytest.raises(MXNetError, match="item 13"):
            rm.rollout_schedule(str(tmp_path / "table.json"))


def test_rollout_requires_thread_mode_and_an_eval_batch():
    with _fleet(replicas=1) as fleet:
        assert fleet.wait_healthy(timeout=30)
        rm = serving.RolloutManager(fleet)
        with pytest.raises(MXNetError, match="eval_batch"):
            rm.rollout_weights(_port_params(7))
    with _fleet(replicas=1) as fleet:
        fleet.mode = "process"
        rm = serving.RolloutManager(fleet, eval_batch=BATCH)
        with pytest.raises(MXNetError, match="thread-mode"):
            rm.rollout_weights(_port_params(7))


def test_rollout_decode_gates_promote():
    """A decode fleet (thread replicas of a 1-layer LM's DecodePredictor):
    a weight refresh passes the health, accuracy, latency, token-parity
    and TTFT gates and is promoted to every replica."""
    geom = dict(page_size=4, num_pages=16, max_seqs=2)

    def lm(seed):
        net = tzoo.transformer_lm(vocab=40, units=24, num_heads=2,
                                  num_layers=1, max_len=48, prefix="tlm_")
        net.initialize(mt.init.Xavier(), ctx=mt.cpu(),
                       generator=torch.Generator().manual_seed(seed))
        return net

    def make():
        return serving.DecodePredictor(lm(0), ctx=mt.cpu(),
                                       prefill_buckets=(8,), **geom)

    cand = {f"arg:{k}": v.detach().clone()
            for k, v in lm(0).collect_params().items()}
    batch = np.arange(8, dtype=np.int32).reshape(1, 8)
    with serving.Fleet(make, replicas=2, probe_interval_ms=60000,
                       server_kw={"batch_timeout_ms": 1.0}) as fleet:
        assert fleet.wait_healthy(timeout=60)
        rm = serving.RolloutManager(fleet, eval_batch=batch, canary_calls=4,
                                    max_latency_x=1e6)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = rm.rollout_weights(cand)
        assert res["action"] == "promote", res
        assert "canary_ttft_us" in res and res["agreement"] == 1.0

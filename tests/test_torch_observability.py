"""The port's observability layer (``mxnet_tpu_torch/observability``: trace,
flight, metrics, alerts) against ``mxnet_tpu``'s, on the CPU, after
``tests/test_observability.py`` and ``tests/test_alerts.py``.

The same sequence of calls runs through both packages and the exported
records are compared: span names, nesting and attributes (ids, clocks and
thread names excluded), metric names and values, flight events, alert
transitions and their evidence. Serving spans come from a 1-bucket
Dense(4) Predictor behind a BatchServer and a 2-replica thread fleet in
each package (weights from one numpy seed). Alert clocks are synthetic.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.observability as jobs  # noqa: E402
from mxnet_tpu import serving as jserving  # noqa: E402
from mxnet_tpu.observability import alerts as jalerts  # noqa: E402
from mxnet_tpu.observability import flight as jflight  # noqa: E402
from mxnet_tpu.observability import metrics as jmetrics  # noqa: E402
from mxnet_tpu.observability import trace as jtrace  # noqa: E402
from mxnet_tpu.resilience import faults as jfaults  # noqa: E402
from mxnet_tpu.resilience import watchdog as jwatchdog  # noqa: E402

import mxnet_tpu_torch.observability as obs  # noqa: E402
from mxnet_tpu_torch import serving  # noqa: E402
from mxnet_tpu_torch.observability import (alerts, flight,  # noqa: E402
                                           metrics, trace)
from mxnet_tpu_torch.resilience import faults, watchdog  # noqa: E402

import _torch_fleet_factories as ff  # noqa: E402

X1 = np.ones((1, ff.IN_UNITS), np.float32)

# one namespace per package
PORT = dict(obs=obs, trace=trace, flight=flight, metrics=metrics,
            alerts=alerts, serving=serving, faults=faults,
            watchdog=watchdog)
REF = dict(obs=jobs, trace=jtrace, flight=jflight, metrics=jmetrics,
           alerts=jalerts, serving=jserving, faults=jfaults,
           watchdog=jwatchdog)


def _ref_predictor(seed=7, prefix="obs_t_"):
    net = mx.gluon.nn.Dense(4, in_units=ff.IN_UNITS, prefix=prefix)
    net.initialize()
    params = net.collect_params()
    for k, v in ff.dense_params(seed).items():
        params[prefix + k].set_data(mx.nd.array(v))
    return jserving.Predictor.from_block(
        net, input_shapes={"data": (ff.IN_UNITS,)}, batch_sizes=(4,),
        warmup=False)


FACTORIES = {"port": ff.dense_predictor, "ref": _ref_predictor}
LIBS = {"port": PORT, "ref": REF}


@pytest.fixture(autouse=True)
def _clean_layer():
    for lib in (PORT, REF):
        lib["trace"].set_enabled(False)
        lib["trace"].clear()
        lib["faults"].reset()
        lib["watchdog"].reset_peers()
        lib["alerts"].reset()
    prev = (alerts.set_enabled(False), jalerts.set_enabled(False))
    yield
    for lib in (PORT, REF):
        lib["trace"].set_enabled(False)
        lib["trace"].clear()
        lib["faults"].reset()
        lib["watchdog"].reset_peers()
        lib["alerts"].reset()
        lib["serving"].reset_stats()
    alerts.set_enabled(prev[0])
    jalerts.set_enabled(prev[1])


def _canon(recs):
    """Span records -> a sorted list of (path of names from the root,
    attributes), ids and clocks left out."""
    by_id = {r["span"]: r for r in recs}
    out = []
    for r in recs:
        path, cur = [r["name"]], r
        while cur["parent"] is not None and cur["parent"] in by_id:
            cur = by_id[cur["parent"]]
            path.append(cur["name"])
        attrs = {k: v for k, v in (r.get("attrs") or {}).items()
                 if k not in ("batch_trace",)}
        out.append((tuple(reversed(path)),
                    tuple(sorted((k, repr(v)) for k, v in attrs.items()))))
    return sorted(out)


def _wait_for_spans(tr, names, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if names <= {s["name"] for s in tr.spans()}:
            return
        time.sleep(0.02)


# ---------------------------------------------------------------- span basics


def _nesting(lib):
    tr = lib["trace"]
    tr.set_enabled(True)
    with tr.span("t.root", step=7):
        with tr.span("t.child"):
            with tr.span("t.grandchild", rows=3):
                pass
        with tr.span("t.sibling"):
            pass
    return tr.spans()


def test_span_nesting_single_thread():
    got, want = _nesting(PORT), _nesting(REF)
    assert _canon(got) == _canon(want)
    assert len({r["trace"] for r in got}) == 1
    assert [r["name"] for r in got] == [r["name"] for r in want]


def _threads(lib):
    tr = lib["trace"]
    tr.set_enabled(True)
    with tr.span("t.producer") as sp:
        ctx = tr.current()

        def consumer():
            with tr.context(ctx):
                with tr.span("t.consumer", worker=1):
                    pass

        t = threading.Thread(target=consumer)
        t.start()
        t.join()
    return sp.trace_id, tr.spans()


def test_span_propagation_across_threads():
    tid, got = _threads(PORT)
    _, want = _threads(REF)
    assert _canon(got) == _canon(want)
    assert {r["trace"] for r in got} == {tid}


def _error(lib):
    tr = lib["trace"]
    tr.set_enabled(True)
    with pytest.raises(ValueError):
        with tr.span("t.boom"):
            raise ValueError("x")
    with tr.span("t.reserved", model="m1") as sp:
        sp.set(**{"name": "resnet", "trace": "x", "dur_ns": 7, "kind": "k"})
    return tr.spans(), [e for e in lib["flight"].events("span")
                        if e["name"] in ("t.boom", "t.reserved")][-2:]


def test_span_error_attr_and_exception_passthrough():
    (got, got_ev), (want, want_ev) = _error(PORT), _error(REF)
    assert _canon(got) == _canon(want)
    assert got[0]["attrs"]["error"] == "ValueError"
    strip = ("seq", "t", "ns", "trace", "dur_ns")
    assert [{k: v for k, v in e.items() if k not in strip} for e in got_ev] \
        == [{k: v for k, v in e.items() if k not in strip} for e in want_ev]


def test_noop_when_disabled():
    for lib in (PORT, REF):
        tr = lib["trace"]
        assert tr.span("x") is tr.span("y")
        with tr.span("x") as s:
            s.set(a=1)
        assert tr.spans() == []


def test_collect_and_ingest_round_trip():
    for lib in (PORT, REF):
        tr = lib["trace"]
        tr.set_enabled(True)
        with tr.collect() as col:
            with tr.span("t.shipped", replica=1):
                pass
        tr.clear()
        assert tr.ingest(col) == 1
        assert [s["name"] for s in tr.spans()] == ["t.shipped"]


def test_context_force_enables_tracing_for_shipped_ctx():
    for lib in (PORT, REF):
        tr = lib["trace"]
        with tr.context(("abc", "p.1"), force=True):
            with tr.span("t.forced"):
                pass
        (rec,) = tr.spans()
        assert rec["trace"] == "abc" and rec["parent"] == "p.1"


# ------------------------------------------------------------ serving spans


def _batchserver_tree(pkg):
    lib = LIBS[pkg]
    tr = lib["trace"]
    tr.set_enabled(True)
    pred = FACTORIES[pkg]()
    with lib["serving"].BatchServer(pred, max_batch_size=4,
                                    batch_timeout_ms=1.0) as server:
        pred_warm = server.submit(X1).result(timeout=60)
        assert pred_warm is not None
        tr.clear()
        with tr.span("client.request") as root:
            with tr.context(root.ctx):
                server.submit(X1).result(timeout=60)
        _wait_for_spans(tr, {"serve.batch", "client.request"})
    return tr.spans(trace_id=root.trace_id)


def test_batchserver_request_span_tree():
    got = _batchserver_tree("port")
    want = _batchserver_tree("ref")
    assert _canon(got) == _canon(want)
    names = {p[-1] for p, _ in _canon(got)}
    assert {"serve.batch", "serve.batch_form", "serve.execute",
            "serve.predict", "serve.sentinel"} <= names


def _coalesced(pkg):
    lib = LIBS[pkg]
    tr = lib["trace"]
    tr.set_enabled(True)
    # two rows fill the batch: it flushes on size, never on the clock
    with lib["serving"].BatchServer(FACTORIES[pkg](), max_batch_size=2,
                                    batch_timeout_ms=60000.0) as server:
        server.submit(np.ones((2, ff.IN_UNITS), np.float32)).result(
            timeout=60)
        tr.clear()
        roots, futs = [], []
        for i in range(2):
            with tr.span("client.request", i=i) as root:
                with tr.context(root.ctx):
                    futs.append(server.submit(X1))
            roots.append(root)
        for f in futs:
            f.result(timeout=60)
        _wait_for_spans(tr, {"serve.coalesced"})
    return [_canon(tr.spans(trace_id=r.trace_id)) for r in roots]


def test_coalesced_follower_requests_get_a_span():
    got, want = _coalesced("port"), _coalesced("ref")
    assert got == want
    assert any(p[-1] == "serve.coalesced" for p, _ in got[1])


def _fleet_tree(pkg):
    lib = LIBS[pkg]
    tr = lib["trace"]
    tr.set_enabled(True)
    with lib["serving"].Fleet(FACTORIES[pkg], replicas=2,
                              probe_interval_ms=60000,
                              server_kw={"batch_timeout_ms": 1.0}) as fleet:
        fleet.submit(X1, deadline_ms=20000).result(timeout=60)
        tr.clear()
        fleet.submit(X1, deadline_ms=20000).result(timeout=60)
        _wait_for_spans(tr, {"serve.request", "serve.batch"})
    (root,) = tr.roots(("serve.request",))
    return tr.spans(trace_id=root["trace"])


def test_fleet_thread_mode_single_connected_tree():
    got, want = _fleet_tree("port"), _fleet_tree("ref")
    assert _canon(got) == _canon(want)
    paths = {p for p, _ in _canon(got)}
    assert ("serve.request", "serve.attempt", "serve.batch",
            "serve.execute", "serve.predict") in paths


def test_fleet_process_mode_tree_crosses_the_pipe():
    """The attempt's context ships to the child replica; its serve.replica
    span comes back with the reply and joins the request's tree."""
    trace.set_enabled(True)
    with serving.Fleet(ff.dense_predictor, replicas=1, mode="process",
                       probe_interval_ms=60000) as fleet:
        fleet.submit(X1, deadline_ms=60000).result(timeout=120)
        _wait_for_spans(trace, {"serve.replica"})
    (root,) = trace.roots(("serve.request",))[-1:]
    paths = {p for p, _ in _canon(trace.spans(trace_id=root["trace"]))}
    assert ("serve.request", "serve.attempt", "serve.replica",
            "serve.predict") in paths
    assert obs.stats()["obs_spans_shipped"] >= 2


def _transitions(pkg):
    lib = LIBS[pkg]
    mark = lib["flight"].last_seq()
    with lib["serving"].Fleet(FACTORIES[pkg], replicas=2,
                              probe_interval_ms=60000,
                              server_kw={"batch_timeout_ms": 1.0}) as fleet:
        fleet.fail_replica(1, reason="test")
        assert fleet.wait_healthy(timeout=60)
    return [(e["replica"], e["prev"], e["state"], e["reason"])
            for e in lib["flight"].events("fleet", since_seq=mark)]


def test_fleet_transitions_land_in_flight_recorder():
    got, want = _transitions("port"), _transitions("ref")
    assert got == want
    assert (1, "HEALTHY", "DRAINING", "test") in got


# ------------------------------------------------------------------ metrics


def _instruments(lib):
    m = lib["metrics"]
    m.reset()
    c = m.counter("x_test_total", "t", labels=("model",))
    g = m.gauge("x_test_gauge", "t")
    h = m.histogram("x_test_ms", "t", labels=("model",),
                    buckets=(1.0, 5.0, 10.0))
    c.inc(2, model="a")
    c.inc(1, model="a")
    g.set(4.5)
    g.inc(0.5)
    for v in (0.5, 3.0, 7.0, 70.0):
        h.observe(v, model="a")
    with pytest.raises(ValueError):
        c.inc(-1, model="a")
    with pytest.raises(ValueError):
        c.inc(1, wrong="x")
    return (c.value(model="a"), g.value(), h.value(model="a"),
            h.percentile(0.5, model="a"), h.percentile(0.99, model="a"))


def test_counter_gauge_histogram_semantics():
    assert _instruments(PORT) == _instruments(REF)


def test_span_histogram_feeds_from_trace():
    for lib in (PORT, REF):
        lib["metrics"].reset()
        lib["trace"].set_enabled(True)
        for _ in range(3):
            with lib["trace"].span("x.timed"):
                pass
        cell = lib["metrics"].get("mxnet_tpu_span_ms").value(name="x.timed")
        assert cell["count"] == 3


def test_render_prometheus_parses():
    """Every typed series the port exports is one mxnet_tpu exports under
    the same name and type, and the text parses line by line."""
    names = {}
    for key, lib in (("port", PORT), ("ref", REF)):
        text = lib["metrics"].render_prometheus(
            include_runtime_counters=False)
        types = {}
        for line in text.splitlines():
            if line.startswith("# TYPE "):
                _, _, name, kind = line.split(" ")
                types[name] = kind
            elif line and not line.startswith("#"):
                name, _, value = line.rpartition(" ")
                float(value)
        names[key] = types
    assert names["port"]
    for name, kind in names["port"].items():
        if name.startswith("mxnet_tpu_"):
            assert names["ref"].get(name) == kind, name
    text = metrics.render_prometheus()
    assert "mxnet_tpu_fleet_requests " in text


def test_json_lines_exporter_round_trip(tmp_path):
    path = str(tmp_path / "m.jsonl")
    metrics.counter("x_json_total", "t").inc(3)
    assert metrics.flush_json(path) == path
    metrics.flush_json(path)
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 2
    assert recs[0]["metrics"]["x_json_total"]["values"][""] == 3
    assert "fleet_requests" in recs[0]["counters"]


def test_background_flusher_cadence(tmp_path):
    path = str(tmp_path / "bg.jsonl")
    assert metrics.start_flusher(path, cadence_s=0.05)
    time.sleep(0.4)
    metrics.stop_flusher()
    with open(path) as f:
        assert len(f.readlines()) >= 2


def _slo_gauges(pkg):
    lib = LIBS[pkg]
    lib["serving"].reset_stats()
    lib["metrics"].reset()
    with lib["serving"].Fleet(FACTORIES[pkg], replicas=2,
                              probe_interval_ms=60000,
                              server_kw={"batch_timeout_ms": 1.0}) as fleet:
        for _ in range(4):
            fleet.submit(X1, deadline_ms=20000).result(timeout=60)
        fleet.submit(X1, deadline_ms=0)
        snap = lib["metrics"].snapshot()
    keep = ("mxnet_tpu_fleet_deadline_hit_rate", "mxnet_tpu_fleet_shed_rate",
            "mxnet_tpu_fleet_healthy_replicas",
            "mxnet_tpu_fleet_breaker_open")
    return {k: snap[k]["values"] for k in keep}


def test_fleet_slo_gauges_derive():
    got, want = _slo_gauges("port"), _slo_gauges("ref")
    assert got == want
    assert got["mxnet_tpu_fleet_deadline_hit_rate"][""] == \
        pytest.approx(1 - 1 / 5)


def test_update_slo_zero_request_window_never_nan():
    for lib in (PORT, REF):
        lib["serving"].reset_stats()
        lib["metrics"].reset()
        lib["metrics"].update_slo()
        snap = lib["metrics"].snapshot()
        assert snap["mxnet_tpu_fleet_deadline_hit_rate"]["values"] == {}


# ------------------------------------------------------------------- flight


def test_flight_recorder_orders_and_filters():
    for lib in (PORT, REF):
        fl = lib["flight"]
        mark = fl.last_seq()
        a = fl.record("x_kind", v=1)
        b = fl.record("y_kind", v=2)
        assert b == a + 1
        evs = fl.events(since_seq=mark)
        assert [e["kind"] for e in evs] == ["x_kind", "y_kind"]
        assert [e["v"] for e in fl.events("y_kind", since_seq=mark)] == [2]


def test_flight_recorder_disable_and_resize():
    prev = flight.set_ring(2)
    try:
        for i in range(4):
            flight.record("x_ring", i=i)
        assert [e["i"] for e in flight.snapshot()] == [2, 3]
        flight.set_ring(0)
        assert flight.record("x_ring") == 0
    finally:
        flight.set_ring(prev)


def test_fired_faults_leave_flight_events():
    got = []
    for lib in (PORT, REF):
        mark = lib["flight"].last_seq()
        with lib["faults"].inject("kv_pool_exhaustion", at_step=1, times=2):
            for _ in range(4):
                lib["faults"].maybe_kv_pool_exhaustion(5)
        got.append([(e["fault"], e["call"])
                    for e in lib["flight"].events("fault", since_seq=mark)])
    assert got[0] == got[1] == [("kv_pool_exhaustion", 1),
                                ("kv_pool_exhaustion", 2)]


def test_dump_has_all_sections():
    d = obs.dump(limit=5)
    assert {"flight", "spans", "metrics", "series", "alerts", "incidents",
            "counters"} <= set(d)
    assert "fleet_requests" in d["counters"]
    json.dumps(d, default=str)


def test_router_close_ends_request_spans():
    trace.set_enabled(True)
    fleet = serving.Fleet(ff.dense_predictor, replicas=1,
                          probe_interval_ms=60000, breaker_k=50)
    fleet.submit(X1, deadline_ms=20000).result(timeout=60)
    with faults.inject("replica_hang", times=1):
        fut = fleet.submit(X1)
        time.sleep(0.05)
        fleet.close()
    with pytest.raises(Exception):
        fut.result(timeout=30)
    outcomes = [r["attrs"].get("outcome") for r in
                trace.roots(("serve.request",))]
    assert "FleetClosed" in outcomes


# ------------------------------------------------------------------- alerts


def test_default_rules_close_over_alert_rule_ids():
    assert sorted(alerts.rules()) == sorted(alerts.ALERT_RULE_IDS)
    assert set(alerts.ALERT_RULE_IDS) <= set(jalerts.ALERT_RULE_IDS)


def _burn_script(lib):
    """One synthetic-clock script through both engines: quiet, a 2% miss
    rate (burn 2 < 4), 8% (FIRING), clean ticks past the cooldown
    (RESOLVED). Returns the transitions and evidence tick by tick."""
    al, srv = lib["alerts"], lib["serving"]
    for rid in list(al.rules()):
        al.unregister_rule(rid)
    rule = al.register_rule(al.BurnRateRule(
        "x_test_burn", "fleet_deadline_exceeded", "fleet_requests",
        objective=0.99, fast_s=60, slow_s=300, factor=4.0, cooldown_s=40.0))
    srv.reset_stats()
    srv._STATS["fleet_requests"] = 1000
    out = []
    t = 1000.0
    for dreq, dmiss, dt in ((0, 0, 0), (100, 2, 30), (100, 8, 30),
                            (100, 0, 30), (100, 0, 30), (100, 0, 60)):
        srv._STATS["fleet_requests"] += dreq
        srv._STATS["fleet_deadline_exceeded"] += dmiss
        t += dt
        out.append((al.evaluate(now=t, force=True), rule.state,
                    json.dumps(rule.last_evidence, sort_keys=True)))
    inc = al.incidents()
    return out, [(i["rule"], i["status"], i["evidence"]) for i in inc]


def test_burn_rate_window_math():
    got, want = _burn_script(PORT), _burn_script(REF)
    assert got == want
    states = [s for _, s, _ in got[0]]
    assert "FIRING" in states and states[-1] == "OK"
    assert got[1][0][:2] == ("x_test_burn", "resolved")


def _default_burns(lib):
    """The default slo_shed_burn / slo_deadline_burn / decode_ttft_burn
    rules on one shed burst, one deadline burst, one TTFT burst."""
    al, srv = lib["alerts"], lib["serving"]
    res = []
    for key, den in (("fleet_shed_overloaded", "fleet_requests"),
                     ("fleet_deadline_exceeded", "fleet_requests"),
                     ("decode_ttft_misses", "decode_sequences")):
        al.reset()
        srv.reset_stats()
        srv._STATS[den] = 100
        al.evaluate(now=1000.0, force=True)
        srv._STATS[den] += 100
        srv._STATS[key] += 50
        res.append(al.evaluate(now=1030.0, force=True))
    return res


def test_shed_deadline_and_ttft_burn_rules_fire():
    got, want = _default_burns(PORT), _default_burns(REF)
    assert got == want
    assert got[0] == {"slo_shed_burn": "FIRING"}
    assert got[1] == {"slo_deadline_burn": "FIRING"}
    assert got[2] == {"decode_ttft_burn": "FIRING"}


def test_slo_counters_applies_the_slo_burn_hook():
    for lib in (PORT, REF):
        srv = lib["serving"]
        srv.reset_stats()
        srv._STATS["fleet_requests"] = 10
        clean = lib["metrics"].slo_counters()
        with lib["faults"].inject("slo_burn", times=1) as f:
            burned = lib["metrics"].slo_counters()
        assert f.fired == 1 and clean["fleet_deadline_exceeded"] == 0
        assert burned["fleet_requests"] == 10 + 64
        assert burned["fleet_deadline_exceeded"] == 64
        assert srv._STATS["fleet_deadline_exceeded"] == 0


def _hold(lib):
    al, srv = lib["alerts"], lib["serving"]
    for rid in list(al.rules()):
        al.unregister_rule(rid)
    rule = al.register_rule(al.BurnRateRule(
        "x_test_hold", "fleet_deadline_exceeded", "fleet_requests",
        objective=0.99, fast_s=60, slow_s=60, factor=4.0, hold_s=50.0))
    srv.reset_stats()
    srv._STATS["fleet_requests"] = 100
    states = []
    t = 1000.0
    for dreq, dmiss, dt in ((0, 0, 0), (10, 10, 10), (1000, 0, 100),
                            (1000, 1000, 10), (100, 100, 60)):
        srv._STATS["fleet_requests"] += dreq
        srv._STATS["fleet_deadline_exceeded"] += dmiss
        t += dt
        states.append((al.evaluate(now=t, force=True), rule.state))
    return states


def test_hold_suppresses_one_tick_flap():
    got, want = _hold(PORT), _hold(REF)
    assert got == want
    assert [s for _, s in got] == ["OK", "PENDING", "OK", "PENDING",
                                   "FIRING"]


class _FakeBreaker:
    is_open = False


class _FakeReplica:
    def __init__(self, rid):
        self.rid = rid
        self.state = "HEALTHY"
        self.scale_drain = False
        self.breaker = _FakeBreaker()

    def latency_snapshot(self):
        return []


class _FakeFleet:
    """The fleet surface the probes read (after tests/test_alerts.py)."""

    _closed = False

    def __init__(self, replicas):
        self._replicas = replicas
        self._sup = self

    def models(self):
        return sorted(self._replicas)

    def replicas(self, model):
        return self._replicas[model]

    def _collect_latencies(self, samples, summaries):
        pass

    def _reset_latencies(self):
        pass


def _probes(lib):
    al = lib["alerts"]
    fleet = _FakeFleet({"m": [_FakeReplica(0), _FakeReplica(1)]})
    lib["serving"]._register_fleet(fleet)
    out = [al.evaluate(now=1000.0, force=True)]
    fleet._replicas["m"][1].breaker.is_open = True
    out.append(al.evaluate(now=1001.0, force=True))
    out.append(al.get_rule("fleet_breaker_open").last_evidence)
    fleet._replicas["m"][0].state = "DRAINING"
    fleet._replicas["m"][1].state = "DEAD"
    out.append(al.evaluate(now=1002.0, force=True))
    out.append(al.get_rule("fleet_healthy_floor").last_evidence)
    out.append(sorted(i["rule"] for i in al.open_incidents()))
    # fleets closed by earlier tests linger until collected: model m only
    out.append([sorted(f.items()) for i in al.open_incidents()
                for f in i["fleet"] if f["model"] == "m"])
    del fleet
    return out


def test_breaker_and_healthy_floor_probes():
    got, want = _probes(PORT), _probes(REF)
    assert got == want
    assert got[1] == {"fleet_breaker_open": "FIRING"}
    assert got[2]["open"] == ["m/1"]
    assert got[3] == {"fleet_healthy_floor": "FIRING"}
    assert got[4]["healthy_by_model"] == {"m": 0}


def test_incident_assembly_is_correlated():
    trace.set_enabled(True)
    with serving.Fleet(ff.dense_predictor, replicas=2,
                       probe_interval_ms=60000,
                       server_kw={"batch_timeout_ms": 1.0}) as fleet:
        for _ in range(3):
            fleet.submit(X1, deadline_ms=20000).result(timeout=60)
        alerts.evaluate(now=1000.0, force=True)
        with faults.inject("slo_burn", times=None):
            alerts.evaluate(now=1030.0, force=True)
            alerts.evaluate(now=1060.0, force=True)
    (inc,) = [i for i in alerts.open_incidents()
              if i["rule"] == "slo_deadline_burn"]
    assert any(e.get("kind") == "fault" for e in inc["flight"])
    assert inc["exemplars"] and inc["exemplars"][0][0]["name"] == \
        "serve.request"
    assert {f["replica"] for f in inc["fleet"]} == {0, 1}
    json.dumps(inc, default=str)


def test_backwards_clock_rebases_firing_rule():
    rule = alerts.register_rule(alerts.BurnRateRule(
        "x_test_back", "fleet_deadline_exceeded", "fleet_requests",
        objective=0.99, fast_s=60, slow_s=60, factor=4.0, cooldown_s=10.0))
    serving.reset_stats()
    serving._STATS["fleet_requests"] = 100
    alerts.evaluate(now=5000.0, force=True)
    serving._STATS["fleet_requests"] += 100
    serving._STATS["fleet_deadline_exceeded"] += 100
    alerts.evaluate(now=5030.0, force=True)
    assert rule.state == "FIRING"
    alerts.evaluate(now=10.0, force=True)
    got = alerts.evaluate(now=30.0, force=True)
    assert got.get("x_test_back") == "RESOLVED"


def test_alert_counters_key_stability():
    assert {"alert_evaluations", "alert_transitions",
            "alert_incidents_opened",
            "alert_incidents_resolved"} <= set(obs.stats())
    assert set(obs.stats()) <= set(jobs.stats())


def test_watchdog_crash_report_embeds_flight_tail(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_TORCH_CRASH_DIR", str(tmp_path))
    flight.record("x_before_stall", marker=1)
    with pytest.raises(watchdog.StallError) as ei:
        with watchdog.guard("batch", timeout=0.2, detail="x_stall_site"):
            time.sleep(3.0)
    path = ei.value.report_path
    assert path and os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        report = json.load(f)
    assert report["phase"] == "batch" and report["detail"] == "x_stall_site"
    assert any(e["kind"] == "x_before_stall"
               for e in report["flight_recorder"])
    assert "fleet_requests" in report["counters"]
    assert any(e["kind"] == "stall" for e in flight.events())

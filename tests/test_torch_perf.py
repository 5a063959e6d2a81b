"""The port's perf ledger (``mxnet_tpu_torch/observability/perf.py``) and
the training alert rules (``observability/alerts.py``), on the CPU.

The ledger keys each captured program by its label and fingerprint and
holds its FLOPs (torch's aten FLOP table plus what the port's kernels
report): a captured Dense step's FLOPs equal FlopCounterMode's count of
the same step exactly (an integer count). MFU and roofline follow from
timed executions against the nominal peaks (the H100's for "cuda"). The
eight training rules each fire on the condition they watch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mxnet_tpu.observability import alerts as jalerts  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import capture, parallel as tpar  # noqa: E402
from mxnet_tpu_torch.observability import (alerts, metrics,  # noqa: E402
                                           numerics, perf, trace)
from mxnet_tpu_torch.resilience import (faults, integrity,  # noqa: E402
                                        sentinel)
from _torch_isolation import no_stale_preemption  # noqa: E402,F401


@pytest.fixture(autouse=True)
def _clean():
    perf.clear()
    alerts.reset()
    numerics.reset()
    yield
    perf.clear()
    alerts.reset()
    numerics.reset()
    faults.reset()


def test_nominal_peaks_and_overrides(monkeypatch):
    assert perf.nominal_peaks("cuda") == (989.0e12, 3.35e12)
    monkeypatch.setenv("MXNET_TPU_TORCH_PERF_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("MXNET_TPU_TORCH_PERF_PEAK_GBPS", "100")
    assert perf.nominal_peaks("cuda") == (1e12, 100e9)


def test_count_flops_adds_what_kernels_report():
    a = torch.randn(8, 16)
    b = torch.randn(16, 4)
    with perf.count_flops() as box:
        a @ b
        perf.add_flops(1000)
    assert box["flops"] == 2 * 8 * 16 * 4 + 1000
    perf.add_flops(5)               # no open counter: nothing to add to


def test_captured_gluon_step_lands_in_the_ledger():
    """One captured Dense step on the CPU: one ledger entry whose FLOPs
    equal FlopCounterMode's count of the same step, bytes those of its
    inputs and outputs; timed executions give MFU and roofline against
    the peaks; the gauges export it and drop it when the ledger is
    cleared."""
    from torch.utils.flop_counter import FlopCounterMode

    net = mt.gluon.nn.Dense(32, in_units=64, prefix="d_")
    net.initialize(ctx=mt.cpu())
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    ce = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    step = capture.capture(tr, net=net, loss_fn=lambda o, y: ce(o, y).mean())
    x = torch.randn(16, 64)
    y = torch.randint(0, 32, (16,)).float()
    step(x, y)
    (key, e), = perf.ledger().items()
    assert key.startswith("trainer_step@") and e["label"] == "trainer_step"
    net2 = mt.gluon.nn.Dense(32, in_units=64, prefix="d_")
    net2.initialize(ctx=mt.cpu())
    tr2 = mt.gluon.Trainer(net2.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    with FlopCounterMode(display=False) as mode:
        with mt.autograd.record():
            loss = ce(net2(x), y).mean()
        loss.backward()
        tr2.step(16)
    assert e["flops"] == mode.get_total_flops() > 0
    assert e["argument_bytes"] == x.numel() * 4 + y.numel() * 4
    perf.note_execution("trainer_step", e["fingerprint"], 1e-3)
    e = perf.ledger()[key]
    peak_flops, peak_bw = perf.nominal_peaks("cpu")
    assert e["mfu"] == pytest.approx(e["flops"] / (1e-3 * peak_flops))
    assert e["roofline_fraction"] == pytest.approx(
        e["bytes_accessed"] / (1e-3 * peak_bw))
    perf.update_gauges()
    assert metrics.get("mxnet_tpu_mfu").value(executable=key) == \
        pytest.approx(e["mfu"])
    perf.clear()
    perf.update_gauges()
    assert metrics.get("mxnet_tpu_mfu").value(executable=key) is None


def test_sharded_step_entries_by_signature():
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    net = transformer.transformer_lm(vocab=40, units=16, num_heads=2,
                                     num_layers=2, max_len=8, impl="flash",
                                     prefix="tlm_")
    net.initialize(ctx=mt.cpu(), generator=torch.Generator().manual_seed(1))
    tr = tpar.ShardedTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(),
                             "adam", {"learning_rate": 0.01},
                             mesh=tpar.create_mesh({"dp": 1}, [mt.cpu()]))
    x = np.random.RandomState(0).randint(0, 40, (4, 8))
    tr.step(x, x)
    tr.step(x, x, microbatches=2)
    led = perf.ledger()
    assert len(led) == 2 and all(k.startswith("sharded_step@") for k in led)
    assert all(e["flops"] > 0 for e in led.values())


def _breach(rule_id):
    return alerts.get_rule(rule_id).state in ("PENDING", "FIRING")


def test_training_rules_are_mxnet_tpus():
    train = {"input_stall_high", "step_time_drift", "perf_device_regression",
             "health_skip_spike", "numerics_nonfinite",
             "numerics_grad_explosion", "numerics_dead_layer",
             "sdc_detected"}
    assert train <= set(alerts.ALERT_RULE_IDS) <= set(jalerts.ALERT_RULE_IDS)
    assert set(alerts.rules()) == set(alerts.ALERT_RULE_IDS)
    assert "pod_host_down" in alerts.ALERT_RULE_IDS     # ported since the
    # pod slice (tests/test_torch_dist_faults.py fires it)


def test_rule_input_stall_high():
    alerts.evaluate(now=10.0, force=True, input_stall=0.1)
    assert not _breach("input_stall_high")
    alerts.evaluate(now=11.0, force=True, input_stall=0.9)
    assert _breach("input_stall_high")


def test_rule_step_time_drift():
    """Ten 10 ms steps banked, then one step_time_anomaly (x10): drift."""
    trace.set_enabled(True)
    try:
        trace.clear()
        for i in range(10):
            trace.record("train.sharded_step", 1000 + i * 10**8, 10**7)
        alerts.evaluate(now=20.0, force=True)
        assert not _breach("step_time_drift")
        trace.record("train.sharded_step", 1000 + 11 * 10**8, 10**7)
        with faults.inject("step_time_anomaly"):
            alerts.evaluate(now=21.0, force=True)
        assert _breach("step_time_drift")
        ev = alerts.get_rule("step_time_drift").last_evidence
        assert ev["dur_ns"] == 10**8
    finally:
        trace.set_enabled(False)


def test_rule_perf_device_regression():
    perf.note_compile("sharded_step", "f" * 32, flops=1e9)
    for _ in range(5):
        perf.note_execution("sharded_step", "f" * 32, 0.010)
    alerts.evaluate(now=30.0, force=True)      # banks the baseline
    assert not _breach("perf_device_regression")
    for _ in range(5):
        perf.note_execution("sharded_step", "f" * 32, 0.050)
    alerts.evaluate(now=31.0, force=True)
    assert _breach("perf_device_regression")


def test_rule_health_skip_spike():
    alerts.evaluate(now=40.0, force=True)
    for _ in range(3):
        sentinel.note_skip("sentinel")
    alerts.evaluate(now=41.0, force=True)
    assert _breach("health_skip_spike")


@pytest.mark.parametrize("cond", ["nonfinite", "grad_explosion",
                                  "dead_layer"])
def test_rules_numerics(cond):
    alerts.evaluate(now=50.0, force=True)
    assert not _breach(f"numerics_{cond}")
    numerics._set_condition(cond, True, evidence={"why": "test"}, step=3)
    alerts.evaluate(now=51.0, force=True)
    assert _breach(f"numerics_{cond}")


def test_rule_sdc_detected():
    alerts.evaluate(now=60.0, force=True)
    integrity._STATS["integrity_audit_mismatches"] += 1
    alerts.evaluate(now=61.0, force=True)
    assert _breach("sdc_detected")

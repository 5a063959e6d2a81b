"""The port's profiler (``mxnet_tpu_torch/profiler.py``) and Chrome-trace
export (``observability/traceview.py``), on the CPU.

``traceview.to_chrome_trace`` gives exactly ``mxnet_tpu``'s events for
the same span records (a foreign process's clock re-based inside its
parent, replica names, attributes). The profiler runs ``torch.profiler``
between ``set_state("run")`` and ``"stop"``; ``dump`` writes its Chrome
trace with the host events appended, ``dumps`` the aggregate tables; the
dispatch ring holds the last ops ``mx.nd`` dispatched.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from mxnet_tpu.observability import traceview as jview  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import profiler  # noqa: E402
from mxnet_tpu_torch.observability import trace, traceview  # noqa: E402


def _records():
    me = f"{os.getpid():x}"
    return [
        {"name": "serve.request", "span": f"{me}.1", "parent": None,
         "trace": "t1", "t0_ns": 1_000_000, "dur_ns": 9_000_000,
         "thread": "MainThread", "attrs": {"model": "lm", "rows": 4}},
        {"name": "serve.replica", "span": "1f.7", "parent": f"{me}.1",
         "trace": "t1", "t0_ns": 55, "dur_ns": 2_000_000,
         "thread": "mxnet-tpu-serving",
         "attrs": {"replica": 1, "blob": [1, 2]}},
        {"name": "serve.batch", "span": "1f.8", "parent": "1f.7",
         "trace": "t1", "t0_ns": 100, "dur_ns": 0, "thread": "worker",
         "attrs": None},
        {"name": "train.sharded_step", "span": f"{me}.2", "parent": None,
         "trace": "t2", "t0_ns": 20_000_000, "dur_ns": 50_000_000,
         "thread": "MainThread", "attrs": {"step": 3}},
        {"bad": "record"},
    ]


def test_to_chrome_trace_equals_mxnet_tpus():
    got = traceview.to_chrome_trace(_records())
    assert got == jview.to_chrome_trace(_records())
    names = {e["args"]["name"] for e in got["traceEvents"]
             if e["name"] == "process_name"}
    assert names == {"main", "replica 1"}
    assert traceview.span_pid({"span": "1f.3"}) == 0x1f


def test_to_chrome_trace_of_live_spans():
    trace.set_enabled(True)
    try:
        trace.clear()
        with trace.span("train.sharded_step", step=1):
            with trace.span("sharded.execute", microbatches=1):
                pass
        spans = trace.spans()
    finally:
        trace.set_enabled(False)
    got = traceview.to_chrome_trace(spans)
    assert got == jview.to_chrome_trace(spans)
    x = [e for e in got["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in x} == {"train.sharded_step",
                                      "sharded.execute"}


def test_profiler_run_dump_dumps(tmp_path):
    path = str(tmp_path / "profile.json")
    profiler.set_config(filename=path)
    profiler.set_state("run")
    assert profiler.state() == "run"
    with profiler.scope("matmul_scope:"):
        torch.randn(64, 64) @ torch.randn(64, 64)
    with profiler.Task("task"):
        pass
    profiler.pause()
    with profiler.Frame("ignored"):
        pass
    profiler.resume()
    profiler.Marker("mark").mark()
    c = profiler.Counter("ctr", value=1)
    c.increment(2)
    profiler.set_state("stop")
    assert profiler.last_profile() is not None
    assert profiler.dump() == path
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"matmul_scope", "task", "mark", "ctr"} <= names
    assert "ignored" not in names
    assert any("mm" in n for n in names if n)    # torch's own op events
    table = profiler.dumps(reset=True)
    assert "matmul_scope" in table and "Dispatch counter" in table
    with pytest.raises(ValueError):
        profiler.set_state("paused")


def test_dispatch_ring_and_stats():
    prev = profiler.set_dispatch_ring(4)
    try:
        for _ in range(3):
            mt.nd.ones((2,), ctx=mt.cpu()).sum()
        ring = profiler.dispatch_ring()
        assert len(ring) == 4 and ring[-1]["op"] == "sum"
        assert [r["seq"] for r in ring] == sorted(r["seq"] for r in ring)
        assert profiler.set_dispatch_ring(0) == 4
        assert profiler.dispatch_ring() == []
    finally:
        profiler.set_dispatch_ring(prev)
    stats = profiler.dispatch_stats()
    assert "capture_steps" in stats and "ckpt_saves" in stats
    assert "integrity_audits" in stats and "elastic_oom_events" in stats

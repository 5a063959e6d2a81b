"""The dist store's fault hooks and collective watchdog, the launcher's
failure record and the pod alert, in the port (``mxnet_tpu/kvstore/
dist.py:178-267``, ``:376-383``, ``:484-488``; ``tools/launch.py``;
``mxnet_tpu/observability/alerts.py:600``), on the CPU.

- ``dist_connect_timeout`` fails connect attempts: retried with backoff
  inside the deadline, one fired fault later the job connects;
- ``hang_collective`` under a 1 s collective deadline raises StallError
  on the wedged rank and on the rank waiting for it;
- a peer killed before an all-reduce surfaces as PeerLostError naming
  it, not a gloo error or a hang;
- ``fingerprint_agree`` counts and flight-records a disagreement;
- ``launch_local(kill_siblings=False)`` keeps the survivors, and
  ``launch_local.last_failure`` names the failing rank, its code and its
  stderr tail;
- the ``pod_host_down`` rule fires from a survivor, as ``mxnet_tpu``'s.
"""
import os
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from mxnet_tpu_torch.kvstore import dist as kd  # noqa: E402
from mxnet_tpu_torch.kvstore import launch  # noqa: E402
from mxnet_tpu_torch.resilience import faults, watchdog  # noqa: E402

import _torch_ranks as ranks  # noqa: E402

RANK_LIMIT = 120.0


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_TPU_TORCH_DIST_CLAIM_DIR", str(tmp_path / "c"))
    faults.reset()
    yield
    faults.reset()


def test_connect_timeout_retries_with_backoff_then_gives_up():
    t0 = time.monotonic()
    with faults.inject("dist_connect_timeout", times=None) as fault:
        with pytest.raises(TimeoutError, match="coordinator"):
            kd.init_distributed("127.0.0.1:9", num_processes=2,
                                process_id=0, timeout=2.0, max_retries=3,
                                backoff=0.1)
    assert time.monotonic() - t0 < 10.0
    assert fault.fired == 4          # the first attempt + 3 retries


def test_connect_timeout_at_0_is_retried_into_a_job():
    """``dist_connect_timeout@0`` fails the first attempt only: the retry
    after the backoff makes the (one-worker) process group."""
    import torch.distributed as dist

    port = launch.free_port()
    try:
        with faults.inject("dist_connect_timeout", at_step=0,
                           times=1) as fault:
            assert kd.init_distributed(f"127.0.0.1:{port}", num_processes=1,
                                       process_id=0, timeout=30.0,
                                       backoff=0.05)
        assert fault.fired == 1 and fault.calls == 2
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["hang", "peer"])
def test_dist_store_collective_faults(tmp_path, mode):
    env = {"MXNET_TPU_TORCH_HEARTBEAT_DIR": str(tmp_path / "hb"),
           "MXNET_TPU_TORCH_CRASH_DIR": str(tmp_path / "crash"),
           "MXNET_TPU_TORCH_WATCHDOG_COLLECTIVE_TIMEOUT":
               "1" if mode == "hang" else "30",
           "MXNET_TPU_TORCH_FAULT_HANG_CAP": "20"}
    world = 2 if mode == "hang" else 3
    exits = {2: faults.FAULT_EXIT_CODE} if mode == "peer" else {}
    out = ranks.run_ranks(ranks.dist_fault_rank, world, (mode,),
                          tmp_path / "ranks", timeout=RANK_LIMIT, env=env,
                          exits=exits, hard_exit=True)
    if mode == "hang":
        for r in out:
            assert r["error"] == "StallError" and r["phase"] == "collective"
            assert r["seconds"] < 15
    else:
        assert out[2] is None
        for r in out[:2]:
            assert r["error"] == "PeerLostError" and r["ranks"] == [2]
            assert r["seconds"] < 15


def test_fingerprint_agree_counts_and_records_a_mismatch(tmp_path):
    out = ranks.run_ranks(ranks.dist_fault_rank, 2, ("agree",),
                          tmp_path / "ranks", timeout=RANK_LIMIT,
                          env={"MXNET_TPU_TORCH_HEARTBEAT_DIR":
                               str(tmp_path / "hb")})
    for r in out:
        assert r["agree"] is False and r["same"] is True
        assert r["mismatches"] == 1 and r["events"] == ["kv_disagree"]


def test_launch_local_failure_record_and_kill_siblings(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_TORCH_LAUNCH_GRACE_S", "3")
    prog = ("import os, sys, time\n"
            "if os.environ['DMLC_WORKER_ID'] == '1':\n"
            "    sys.stderr.write('boom-from-rank1')\n"
            "    sys.exit(7)\n"
            "time.sleep(float(os.environ.get('SLEEP', '60')))\n")
    t0 = time.monotonic()
    assert launch.launch_local(2, [sys.executable, "-c", prog]) == 7
    assert time.monotonic() - t0 < 30, "the sibling was not torn down"
    fail = launch.launch_local.last_failure
    assert fail["rank"] == 1 and fail["code"] == 7
    assert "boom-from-rank1" in fail["stderr_tail"]
    # the survivor outlives the failure and ends on its own
    t0 = time.monotonic()
    rc = launch.launch_local(2, [sys.executable, "-c", prog],
                             env_extra={"SLEEP": "2"}, kill_siblings=False)
    assert rc == 7 and time.monotonic() - t0 >= 2.0
    assert launch.launch_local.last_failure["rank"] == 1
    assert launch.launch_local(2, [sys.executable, "-c", "pass"]) == 0
    assert launch.launch_local.last_failure is None


def test_pod_host_down_fires_as_mxnet_tpus():
    from mxnet_tpu.observability import alerts as jal
    from mxnet_tpu.resilience import watchdog as jwd

    from mxnet_tpu_torch.observability import alerts as tal

    got = []
    for al, wd in ((tal, watchdog), (jal, jwd)):
        al.reset()
        wd.reset_pod()
        seen = [al.evaluate(now=1000.0, force=True)]
        wd.configure_pod(2, 0)
        seen.append(al.evaluate(now=1001.0, force=True))
        wd.mark_host_dead(1)
        seen.append(al.evaluate(now=1002.0, force=True))
        seen.append(al.get_rule("pod_host_down").last_evidence)
        seen.append(sorted(i["rule"] for i in al.open_incidents()))
        wd.configure_pod(1, 0)      # the shrink re-admits: resolved
        seen.append(al.evaluate(now=1100.0, force=True))
        wd.reset_pod()
        al.reset()
        got.append(seen)
    assert got[0] == got[1]
    assert got[0][2] == {"pod_host_down": "FIRING"}
    assert got[0][3]["dead_hosts"] == [1]

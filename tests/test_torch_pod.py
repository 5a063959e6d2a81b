"""The port's pod layer against ``mxnet_tpu``'s, on the CPU: host failure
domains (``PodTopology``, ``pod_mesh``, ``shrink_mesh_hosts``), the
watchdog's liveness layer over ranks (beats, dead and zombie pids,
staleness, the survivors' barrier), ``rearm_microbatches``, the step
fingerprint over 2 and 4 gloo ranks (bitwise ``mxnet_tpu``'s ``fold_host``
of the gathered state, a table whose rows do not divide included), and
the distributed checkpoint commit: written by 2 port ranks and restored
by ``mxnet_tpu``, written by ``mxnet_tpu``'s simulated pod and restored by
2 port ranks, bitwise; a crash between a rank's shards and its marker
leaves the last whole checkpoint and debris, never a torn manifest.

Every spawned run of ranks has its own time limit
(``tests/_torch_ranks.py``).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu.parallel import mesh as jmesh  # noqa: E402
from mxnet_tpu.resilience import checkpoint as jckpt  # noqa: E402
from mxnet_tpu.resilience import elastic as jelastic  # noqa: E402
from mxnet_tpu.resilience import integrity as jintegrity  # noqa: E402
from mxnet_tpu.resilience import watchdog as jwatchdog  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from mxnet_tpu_torch.resilience import (CheckpointManager,  # noqa: E402
                                        checkpoint, elastic, watchdog)

import _torch_ranks as ranks  # noqa: E402
from _torch_isolation import no_stale_preemption  # noqa: E402,F401

LM_DIMS = (1, 16, 2, 31, 8)     # layers, units, heads, vocab, max_len
RANK_LIMIT = 120.0


@pytest.fixture(autouse=True)
def _clean_pod():
    watchdog.reset_pod()
    watchdog.reset_peers()
    yield
    watchdog.reset_pod()
    watchdog.reset_peers()


def _dead_pid():
    """A pid that is certainly not alive: a child that already exited."""
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    return p.pid


def _jax_devices():
    import jax

    devs = jax.devices("cpu")
    assert len(devs) >= 8
    return devs[:8]


def _arith_mesh(axes):
    """The port's arithmetic mesh of 8 ranks over ``axes`` (no groups)."""
    arr = np.empty([axes[a] for a in axes], dtype=object)
    for i in range(arr.size):
        arr.flat[i] = torch.device("cpu")
    return tmesh.Mesh(arr, tuple(axes))


# ------------------------------------------------------------- topology
def test_topology_matches_mxnet_tpu():
    jt = jmesh.PodTopology.simulated(4, _jax_devices())
    tt = tmesh.PodTopology.simulated(4, [torch.device("cpu")] * 8)
    for t in (jt, tt):
        assert (t.num_hosts, t.devices_per_host, t.this_host) == (4, 2, 0)
    for h in range(4):
        assert tt.host_ordinals(h) == jt.host_ordinals(h)
    assert [tt.host_of(o) for o in range(8)] == \
        [jt.host_of(o) for o in range(8)]
    assert tt.hosts() == jt.hosts()
    assert tt.describe() == jt.describe()
    kept = (1, 3)
    assert tt.shrunk(kept).describe() == jt.shrunk(kept).describe()
    for lib, devs in ((jmesh, _jax_devices()),
                      (tmesh, [torch.device("cpu")] * 8)):
        with pytest.raises(ValueError, match="equal virtual hosts"):
            lib.PodTopology.simulated(3, devs)
        with pytest.raises(ValueError, match="out of range"):
            lib.PodTopology.simulated(4, devs).host_ordinals(4)


SHRINK_CASES = [
    # (hosts, axes, dead hosts, batch axis)
    (4, {"dp": 8}, [0], "dp"),
    (2, {"dp": 2, "tp": 4}, [1], "dp"),
    (4, {"dp": 2, "tp": 4}, [1], "dp"),              # misaligned: raises
    (2, {"fsdp": 2, "dp": 4}, [1], ("dp", "fsdp")),   # a host a fsdp slot
    (2, {"fsdp": 2, "dp": 4}, [0], ("dp", "fsdp")),   # the coordinator's
    (4, {"dp": 8}, [1, 2, 3], "dp"),
    (4, {"dp": 8}, [0, 1, 2, 3], "dp"),              # nothing left
    (2, {"dp": 8}, [0, 1, 5], "dp"),                 # out of range
    (4, {"dp": 4, "tp": 2}, [], "dp"),               # no dead host
]


@pytest.mark.parametrize("hosts,axes,dead,batch", SHRINK_CASES)
def test_shrink_mesh_hosts_matches_mxnet_tpu(hosts, axes, dead, batch):
    """The same new axes, surviving device ordinals (the port's
    ``source_ranks``), kept hosts and renumbered topology as
    ``mxnet_tpu``'s on its 8 CPU devices, or the same MeshShrinkError."""
    devs = _jax_devices()
    jtopo = jmesh.PodTopology.simulated(hosts, devs)
    jm, _ = jmesh.pod_mesh(axes, jtopo)
    ttopo = tmesh.PodTopology.simulated(hosts, [torch.device("cpu")] * 8)
    tm = _arith_mesh(axes)
    try:
        want = jmesh.shrink_mesh_hosts(jm, dead, jtopo, batch_axis=batch)
    except jmesh.MeshShrinkError as e:
        with pytest.raises(tmesh.MeshShrinkError) as got:
            tmesh.shrink_mesh_hosts(tm, dead, ttopo, batch_axis=batch)
        assert str(got.value) == str(e)
        assert got.value.axes == e.axes
        return
    new, topo, kept = tmesh.shrink_mesh_hosts(tm, dead, ttopo,
                                              batch_axis=batch)
    jnew, jtopo2, jkept = want
    assert new.shape == dict(zip(jnew.axis_names, jnew.devices.shape))
    assert [int(r) for r in new.source_ranks.flat] == \
        [devs.index(d) for d in jnew.devices.flat]
    assert kept == jkept
    assert topo.describe() == jtopo2.describe()
    assert new._groups == {}


@pytest.mark.parametrize("dead,axes", [([3], {"dp": 4}), ([1], {"dp": 4}),
                                       ([5], {"dp": 2, "tp": 4}),
                                       ([0, 1], {"dp": 8})])
def test_shrink_mesh_source_ranks_are_mxnet_tpus_devices(dead, axes):
    """``shrink_mesh``'s result holds, as ``source_ranks``, the ordinals of
    the devices ``mxnet_tpu``'s keeps."""
    devs = _jax_devices()[:int(np.prod(list(axes.values())))]
    jm = jmesh.create_mesh(axes, devs)
    want = jmesh.shrink_mesh(jm, dead)
    got = tmesh.shrink_mesh(_arith_mesh(axes) if len(devs) == 8 else
                            tmesh.Mesh(np.array(
                                [torch.device("cpu")] * len(devs),
                                dtype=object).reshape(jm.devices.shape),
                                tuple(axes)), dead)
    assert got.shape == dict(zip(want.axis_names, want.devices.shape))
    assert [int(r) for r in got.source_ranks.flat] == \
        [devs.index(d) for d in want.devices.flat]


@pytest.mark.parametrize("n,old,new", [(1, 4, 2), (2, 4, 2), (4, 8, 2),
                                       (3, 4, 4), (2, 2, 4), (8, 4, 1)])
def test_rearm_microbatches_matches_mxnet_tpu(n, old, new):
    assert elastic.rearm_microbatches(n, old, new) == \
        jelastic.rearm_microbatches(n, old, new)


def test_mesh_shrink_knob(monkeypatch):
    assert elastic.mesh_shrink_enabled()
    monkeypatch.setenv("MXNET_TPU_TORCH_MESH_SHRINK", "0")
    assert not elastic.mesh_shrink_enabled()


# -------------------------------------------------------------- liveness
def test_peer_lost_error_is_a_stall_error_in_both_packages():
    for lib in (jwatchdog, watchdog):
        assert issubclass(lib.PeerLostError, lib.StallError)
        err = lib.PeerLostError("x")
        assert err.ranks == () and err.hosts == ()
        try:
            raise err
        except lib.StallError as caught:
            assert caught is err


def test_configure_pod_validates_and_resets():
    for lib in (jwatchdog, watchdog):
        with pytest.raises(ValueError):
            lib.configure_pod(0, 0)
        with pytest.raises(ValueError):
            lib.configure_pod(2, 2)
        lib.configure_pod(4, 1)
        snap = lib.pod_snapshot()
        assert snap["configured"] and snap["live_hosts"] == [0, 1, 2, 3]
        lib.mark_host_dead(2)
        assert lib.dead_hosts() == [2] and \
            lib.pod_snapshot()["dead_hosts"] == [2]
        lib.configure_pod(4, 1)      # re-declaration re-admits
        assert lib.dead_hosts() == []
        lib.reset_pod()


def test_coordinator_is_lowest_live_host():
    for lib in (jwatchdog, watchdog):
        assert lib.coordinator() is None
        lib.configure_pod(3, 0)
        assert lib.coordinator() == 0
        lib.mark_host_dead(0)
        assert lib.coordinator() == 1
        lib.reset_pod()


def _forge_beat(d, rank, pid, gen=0, host=None):
    with open(os.path.join(d, f"rank-{rank}.gen{gen}.hb"), "w") as f:
        json.dump({"rank": rank, "host": host, "pid": pid,
                   "hostname": watchdog._HOSTNAME, "time": time.time()}, f)


def test_heartbeat_dead_pid_detection(tmp_path):
    """A beat whose writer is gone marks its rank, and on a pod its whole
    host, dead: PeerLostError naming every rank of the host."""
    hb = str(tmp_path / "hb")
    watchdog.configure_liveness(4, 0, heartbeat_dir=hb)
    watchdog.configure_pod(2, 0, devices_per_host=2)
    mine = os.path.join(hb, "rank-0.gen0.hb")
    assert json.load(open(mine))["pid"] == os.getpid()
    _forge_beat(hb, 1, os.getpid(), host=0)
    _forge_beat(hb, 3, _dead_pid(), host=1)
    with pytest.raises(watchdog.PeerLostError) as exc:
        watchdog.check_hosts("unit")
    assert exc.value.hosts == (1,) and exc.value.ranks == (2, 3)
    assert watchdog.dead_hosts() == [1] and watchdog.dead_peers() == [3]


def test_a_zombie_is_dead(tmp_path):
    """An exited child its parent has not reaped still answers kill(pid,
    0): the liveness layer reads its state and calls it dead."""
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    deadline = time.time() + 20
    while time.time() < deadline:
        try:
            with open(f"/proc/{p.pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    break
        except OSError:
            break
        time.sleep(0.01)
    try:
        os.kill(p.pid, 0)           # still a process table entry
        assert not watchdog._pid_alive(p.pid)
    finally:
        p.wait()
    assert watchdog._pid_alive(os.getpid())


def test_heartbeat_staleness_rule(tmp_path, monkeypatch):
    hb = str(tmp_path / "hb")
    monkeypatch.setenv("MXNET_TPU_TORCH_HOST_HEARTBEAT_TIMEOUT", "0.2")
    watchdog.configure_liveness(2, 0, heartbeat_dir=hb)
    watchdog.heartbeat(rank=1)      # a live pid, but the beat goes stale
    old = time.time() - 5.0
    os.utime(os.path.join(hb, "rank-1.gen0.hb"), (old, old))
    with pytest.raises(watchdog.PeerLostError) as exc:
        watchdog.check_peers("unit")
    assert exc.value.ranks == (1,) and exc.value.hosts == ()
    # a rank that never beat is still starting: no verdict
    watchdog.reset_peers()
    watchdog.configure_liveness(3, 0, heartbeat_dir=str(tmp_path / "hb2"))
    watchdog.check_peers("unit")


def test_pod_barrier_simulated_is_noop():
    watchdog.configure_pod(4, 0)    # no job directory: one process is it
    assert watchdog.pod_barrier() == (0, 1, 2, 3)
    assert jwatchdog.configure_pod(4, 0) and jwatchdog.pod_barrier() == \
        (0, 1, 2, 3)
    jwatchdog.reset_pod()


def test_settle_dead_takes_the_union_of_the_views(tmp_path):
    """The survivors' barrier: a peer that arrived knowing of a death this
    rank missed makes it dead here too; a peer that never arrives is dead
    after the timeout (and pod_barrier then raises, as mxnet_tpu's)."""
    hb = str(tmp_path / "hb")
    watchdog.configure_liveness(4, 0, heartbeat_dir=hb)
    for r in (1, 2):
        _forge_beat(hb, r, os.getpid())
    _forge_beat(hb, 3, os.getpid())
    for r in (1, 2):
        with open(os.path.join(hb, f"barrier-t1-rank{r}.json"), "w") as f:
            json.dump({"dead": [3]}, f)
    assert watchdog.settle_dead(tag="t1", timeout=5) == (3,)
    assert watchdog.dead_peers() == [3]
    watchdog.reset_peers()
    watchdog.configure_pod(2, 0, devices_per_host=2)
    with pytest.raises(watchdog.PeerLostError) as exc:
        watchdog.pod_barrier(tag="t2", timeout=0.3)
    assert exc.value.hosts == (0, 1) or exc.value.hosts == (1,)
    assert 1 in watchdog.dead_hosts()


def test_update_pod_gauges_prune_renumbered_hosts():
    from mxnet_tpu_torch.observability import metrics

    assert metrics.update_pod() is None
    watchdog.configure_pod(4, 0)
    watchdog.mark_host_dead(3)
    snap = metrics.update_pod()
    assert snap["dead_hosts"] == [3]
    assert metrics._POD_HOSTS.value() == 4
    assert metrics._POD_HOSTS_LIVE.value() == 3
    assert metrics._POD_HOST_UP.value(host=0) == 1.0
    assert metrics._POD_HOST_UP.value(host=3) == 0.0
    watchdog.configure_pod(2, 0)    # a shrink renumbers
    metrics.update_pod()
    assert metrics._POD_HOST_UP.value(host=3) is None
    assert metrics._POD_HOSTS_LIVE.value() == 2


# ------------------------------------------------------ the fingerprint
def _lm_values_and_batch():
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    layers, units, heads, vocab, t = LM_DIMS
    torch.manual_seed(0)
    net = transformer.transformer_lm(vocab=vocab, units=units,
                                     num_heads=heads, num_layers=layers,
                                     max_len=t, impl="flash", prefix="tlm_")
    net.initialize(ctx=mt.cpu())
    values = {k: p.data().detach().numpy().copy()
              for k, p in net._param_objects().items()}
    rng = np.random.default_rng(1)
    x = rng.integers(0, vocab, (8, t)).astype(np.int64)
    return values, x, ((5 * x + 3) % vocab).astype(np.int64)


@pytest.mark.parametrize("world,axes", [(2, {"dp": 2}),
                                        (4, {"fsdp": 2, "dp": 2})])
def test_fingerprint_over_ranks_is_fold_host_of_the_gathered_state(
        tmp_path, world, axes):
    """Each rank sums the leaves it counts (one rank per element; fsdp's
    zero padding adds nothing), the sums are all-reduced, the chain runs:
    the step fingerprint and the state fingerprint equal mxnet_tpu's
    ``fold_host`` of the gathered parameters and gradients, bitwise, on
    every rank; the 31-row tables split over fsdp with padding."""
    values, x, y = _lm_values_and_batch()
    out = ranks.run_ranks(ranks.fingerprint_rank, world,
                          (values, x, y, axes, LM_DIMS), tmp_path,
                          timeout=RANK_LIMIT)
    r0 = out[0]
    if "fsdp" in axes:
        assert "tlm_embed_weight" in r0["sharded"]
    named = {f"param:{k}": v for k, v in r0["params"].items()}
    named.update({f"grad:{k}": g for k, g in r0["grads"].items()})
    want = jintegrity.fold_host(named)
    want_state = jintegrity.fold_host(
        {f"param:{k}": v for k, v in r0["params"].items()})
    for r in out:
        assert r["fp"] == want
        assert r["state_fp"] == want_state


# --------------------------------------------------- distributed commit
def _mlp_pair():
    """The checkpoint tests' MLP in both packages, the port's values
    mxnet_tpu's."""
    j = mx.gluon.nn.HybridSequential(prefix="m_")
    with j.name_scope():
        j.add(mx.gluon.nn.Dense(8, in_units=4, activation="relu"),
              mx.gluon.nn.BatchNorm(in_channels=8),
              mx.gluon.nn.Dense(3, in_units=8))
    j.initialize()
    values = {k: p.data().asnumpy() for k, p in j.collect_params().items()}
    return j, values


RNG = np.random.RandomState(0)
X = RNG.randn(8, 4).astype(np.float32)
Y = RNG.randint(0, 3, 8).astype(np.float32)


def test_pod_commit_restores_into_mxnet_tpu_bitwise(tmp_path):
    """2 port ranks (one a host) commit: each host writes only its own
    shards (``-h000-`` and ``-h001-`` payloads, the replicated arrays once,
    by host 0), the manifest carries the ``pod`` stamp and no marker dir,
    an async pod save raises ValueError; ``mxnet_tpu``'s
    ``restore_latest`` restores every parameter bitwise."""
    j, values = _mlp_pair()
    ckpt = str(tmp_path / "ckpt")
    out = ranks.run_ranks(ranks.pod_commit_rank, 2, (values, X, Y, ckpt),
                          tmp_path / "ranks", timeout=RANK_LIMIT)
    assert all("synchronous" in r["async"] for r in out)
    path = os.path.join(ckpt, "ckpt-00000001")
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["pod"] == {"num_hosts": 2, "devices_per_host": 1}
    hosts = {f.split("-")[1] for f in out[0]["files"]}
    assert hosts == {"h000", "h001"}
    assert not os.path.isdir(os.path.join(path, "commit"))
    assert not [d for d in os.listdir(ckpt) if d.endswith(".tmp.pod")]
    w = manifest["arrays"]["param:m_dense1_weight"]
    assert [s["index"] for s in w["shards"]] == [[[0, 2], [0, 8]],
                                                 [[2, 3], [0, 8]]]
    bias = manifest["arrays"]["param:m_dense0_bias"]["shards"]
    assert len(bias) == 1 and "-h000-" in bias[0]["file"]
    jt = jpar.ShardedTrainer(j, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             "adam", {"learning_rate": 0.01})
    m = jckpt.CheckpointManager(ckpt).restore_latest(trainer=jt)
    assert m["step"] == 1
    for k, v in out[0]["params"].items():
        got = np.asarray(jt.params[k])
        assert got.tobytes() == v.tobytes(), k


def test_mxnet_tpu_pod_commit_restores_into_two_port_ranks(tmp_path):
    """A commit of ``mxnet_tpu``'s simulated pod (2 virtual hosts over its
    8 CPU devices, the weights split over dp) restores into 2 port ranks
    laid out as a pod over fsdp: parameters, Adam's moments, the step
    count and BatchNorm's statistics bitwise."""
    import jax
    from jax.sharding import PartitionSpec as P

    j, values = _mlp_pair()
    devs = jax.devices("cpu")[:8]
    topo = jmesh.PodTopology.simulated(2, devs)
    ckpt = str(tmp_path / "ckpt")
    mgr = jckpt.CheckpointManager(ckpt, pod=topo)
    jt = jpar.ShardedTrainer.for_pod(
        j, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 0.01}, axes={"dp": 8}, topology=topo,
        checkpoint_manager=mgr,
        param_rules=[(r".*dense0_weight$", P("dp", None))])
    jt.step(X, Y)
    mgr.save(1, trainer=jt)
    manifest = json.load(open(os.path.join(ckpt, "ckpt-00000001",
                                           "manifest.json")))
    assert manifest["pod"]["num_hosts"] == 2
    out = ranks.run_ranks(ranks.pod_restore_rank, 2, (values, ckpt),
                          tmp_path / "ranks", timeout=RANK_LIMIT)
    m_state = {k: np.asarray(v[0]) for k, v in
               jt.opt_state["state"].items()} if isinstance(
        jt.opt_state, dict) else None
    for r in out:
        assert r["step"] == 1 and r["t"] == 1
        for k, v in r["params"].items():
            assert v.tobytes() == np.asarray(jt.params[k]).tobytes(), k
        for k, v in r["aux"].items():
            assert v.tobytes() == np.asarray(jt.aux[k]).tobytes(), k
        if m_state is not None:
            for k, v in r["m"].items():
                assert v.tobytes() == m_state[k].tobytes(), k


def test_partial_pod_commit_leaves_debris_never_a_torn_manifest(tmp_path):
    """``ckpt_partial_pod`` kills rank 1 between its shards and its
    marker in the step-2 commit: rank 0's barrier times out, nothing is
    published, the shared temp dir stays as debris, and a restore takes
    the whole step-1 checkpoint."""
    _, values = _mlp_pair()
    ckpt = str(tmp_path / "ckpt")
    out = ranks.run_ranks(ranks.pod_commit_rank, 2,
                          (values, X, Y, ckpt, 2), tmp_path / "ranks",
                          timeout=RANK_LIMIT)
    assert out[1]["saves"][2] == "crashed"
    assert out[0]["saves"][2].startswith("timeout")
    assert not os.path.isdir(os.path.join(ckpt, "ckpt-00000002"))
    debris = [d for d in os.listdir(ckpt) if d.endswith(".tmp.pod")]
    assert debris == [".ckpt-00000002.tmp.pod"]
    assert not os.path.isfile(os.path.join(ckpt, debris[0],
                                           "manifest.json"))
    back = ranks.run_ranks(ranks.pod_restore_rank, 2, (values, ckpt),
                           tmp_path / "restore", timeout=RANK_LIMIT)
    for r in back:
        assert r["step"] == 1
        for k, v in out[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], v)


def test_prune_never_races_a_live_pod_writer(tmp_path, monkeypatch):
    """Retention does not delete a manifest-absent checkpoint dir another
    host may still be writing, until it has been quiet past the orphan
    grace; a pod commit's shared temp dir the same."""
    checkpoint.reset_stats()
    net = mt.gluon.nn.Dense(2, in_units=2)
    net.initialize(ctx=mt.cpu())
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep_n=1)
    for step in (1, 2):
        mgr.save(step, net=net)
    assert [s for s, _ in mgr.list_checkpoints()] == [2]
    straggler = os.path.join(mgr.directory, "ckpt-00000000")
    os.makedirs(os.path.join(straggler, "arrays"))
    with open(os.path.join(straggler, "arrays", "x.bin"), "wb") as f:
        f.write(b"live writer")
    pod_tmp = os.path.join(mgr.directory, ".ckpt-00000009.tmp.pod")
    os.makedirs(pod_tmp)
    mgr.save(3, net=net)
    assert os.path.isdir(straggler) and os.path.isdir(pod_tmp)
    assert checkpoint.stats()["ckpt_prune_deferred"] >= 1
    monkeypatch.setenv("MXNET_TPU_TORCH_CKPT_ORPHAN_GRACE_S", "0")
    time.sleep(0.01)
    mgr.save(4, net=net)
    assert not os.path.isdir(straggler) and not os.path.isdir(pod_tmp)

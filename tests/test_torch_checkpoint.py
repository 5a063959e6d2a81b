"""The port's checkpoints (``mxnet_tpu_torch/resilience/checkpoint.py``)
against ``mxnet_tpu``'s, on the CPU.

Format v2 is shared: a checkpoint written by ``mxnet_tpu``'s
ShardedTrainer restores into the port's with parameters, aux and optimizer
state bitwise (``aux:__rng_key__``, a JAX key, is skipped), and one
written by the port restores into ``mxnet_tpu``'s with parameters bitwise
(integers and raw bits: no tolerance). The fall-backs (torn, CRC-corrupt,
missing manifest, a fingerprint that disagrees), ``keep_n``, the async
thread writer, the gluon Trainer's states with the loss scaler and the
generators, the sentinel's policies and the step watchdog's rollback, and
resharding over 2 CPU ranks.
"""
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu.resilience import checkpoint as jckpt  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import parallel as tpar  # noqa: E402
from mxnet_tpu_torch.resilience import (CheckpointManager,  # noqa: E402
                                        CheckpointCorruptError,
                                        HealthSentinel, NumericHealthError,
                                        faults, sentinel, watchdog)

import _torch_ranks as ranks  # noqa: E402

RNG = np.random.RandomState(0)
X = RNG.randn(8, 4).astype(np.float32)
Y = RNG.randint(0, 3, 8).astype(np.float32)


def _mlp(lib, **init):
    n = lib.gluon.nn.HybridSequential(prefix="m_")
    with n.name_scope():
        n.add(lib.gluon.nn.Dense(8, in_units=4, activation="relu"),
              lib.gluon.nn.BatchNorm(in_channels=8),
              lib.gluon.nn.Dense(3, in_units=8))
    n.initialize(**init)
    return n


def _pair():
    """The same MLP in both packages (the port's weights from
    mxnet_tpu's)."""
    j = _mlp(mx)
    t = _mlp(mt, ctx=mt.cpu())
    jp = j.collect_params()
    for name, p in t._param_objects().items():
        p.set_data(jp[name].data().asnumpy())
    return j, t


def _tt(net, opt="adam"):
    return tpar.ShardedTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(),
                               opt, {"learning_rate": 0.01},
                               mesh=tpar.create_mesh({"dp": 1}, [mt.cpu()]))


def _jt(net, opt="adam"):
    return jpar.ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                               opt, {"learning_rate": 0.01})


@pytest.fixture(autouse=True)
def _clean():
    from mxnet_tpu_torch.resilience import integrity

    faults.reset()
    integrity.clear_preempt()   # no SIGTERM another test sent
    yield
    faults.reset()


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_mxnet_tpu_checkpoint_restores_into_the_port(tmp_path, opt):
    """mxnet_tpu's ShardedTrainer, 2 steps, saved: the port's trainer
    restores params, aux and every opt_state leaf bitwise."""
    j, t = _pair()
    jt = _jt(j, opt)
    for _ in range(2):
        jt.step(X, Y)
    jckpt.CheckpointManager(str(tmp_path)).save(2, trainer=jt)
    tt = _tt(t, opt)
    m = CheckpointManager(str(tmp_path)).restore_latest(trainer=tt)
    assert m["step"] == 2 and tt.opt_state["t"] == 2
    for k, v in jt.params.items():
        np.testing.assert_array_equal(tt.params[k].numpy(), np.asarray(v))
    for k, v in tt.aux.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jt.aux[k]))
    import jax

    want = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(jt.opt_state)[0]}
    got = {k[len("opt:"):]: v for k, v in tt._checkpoint_arrays()
           if k.startswith("opt:")}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_port_checkpoint_restores_into_mxnet_tpu(tmp_path):
    """The port's trainer, 2 steps, saved with its integrity fingerprint:
    mxnet_tpu restores it (and verifies the fingerprint) with params
    bitwise."""
    j, t = _pair()
    tt = _tt(t)
    for _ in range(2):
        tt.step(X, Y)
    os.environ["MXNET_TPU_TORCH_INTEGRITY_FINGERPRINT"] = "1"
    try:
        CheckpointManager(str(tmp_path)).save(2, trainer=tt)
    finally:
        del os.environ["MXNET_TPU_TORCH_INTEGRITY_FINGERPRINT"]
    jt = _jt(j)
    m = jckpt.CheckpointManager(str(tmp_path)).restore_latest(trainer=jt)
    assert m["step"] == 2 and m["integrity"]["algo"] == "xsf32-v1"
    for k, v in tt.params.items():
        np.testing.assert_array_equal(np.asarray(jt.params[k]), v.numpy())
    assert int(np.asarray(jt.opt_state["t"])) == 2


def _trained(tmp_path, steps=(1, 2, 3), keep_n=5):
    _, t = _pair()
    tt = _tt(t)
    mgr = CheckpointManager(str(tmp_path), keep_n=keep_n)
    for s in steps:
        tt.step(X, Y)
        mgr.save(s, trainer=tt)
    return tt, mgr


@pytest.mark.parametrize("kind", ["torn", "crc", "no_manifest",
                                  "partial_write", "fingerprint"])
def test_a_bad_checkpoint_is_never_restored(tmp_path, kind):
    """The newest checkpoint is made bad five ways; restore_latest skips
    it (a warning, ckpt_restore_skipped) and restores the one before,
    bitwise, leaving nothing of the bad one in the trainer."""
    tt, mgr = _trained(tmp_path, steps=(1,))
    want = {k: v.clone() for k, v in tt.params.items()}
    tt.step(X, Y)
    if kind == "torn":
        with faults.inject("ckpt_crash_before_manifest"), \
                pytest.raises(faults.SimulatedCrash):
            mgr.save(2, trainer=tt)
        assert [n for n in os.listdir(tmp_path) if ".tmp." in n]
    elif kind == "crc":
        with faults.inject("ckpt_shard_corrupt"):
            mgr.save(2, trainer=tt)
    elif kind == "partial_write":
        with faults.inject("ckpt_partial_write", at_step=1):
            mgr.save(2, trainer=tt)
    elif kind == "no_manifest":
        path = mgr.save(2, trainer=tt)
        os.unlink(os.path.join(path, "manifest.json"))
    else:
        os.environ["MXNET_TPU_TORCH_INTEGRITY_FINGERPRINT"] = "1"
        try:
            path = mgr.save(2, trainer=tt)
        finally:
            del os.environ["MXNET_TPU_TORCH_INTEGRITY_FINGERPRINT"]
        import json

        mpath = os.path.join(path, "manifest.json")
        with open(mpath) as f:
            man = json.load(f)
        man["integrity"]["params"] ^= 1
        with open(mpath, "w") as f:
            json.dump(man, f)
    fresh = _tt(_pair()[1])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m = CheckpointManager(str(tmp_path)).restore_latest(trainer=fresh)
    assert m["step"] == 1
    if kind != "torn":
        assert any("skipping corrupt checkpoint" in str(w.message)
                   for w in caught)
    for k, v in want.items():
        assert torch.equal(fresh.params[k], v)


def test_enospc_leaves_earlier_checkpoints(tmp_path):
    tt, mgr = _trained(tmp_path, steps=(1,))
    with faults.inject("ckpt_enospc"), pytest.raises(OSError):
        mgr.save(2, trainer=tt)
    assert [s for s, _ in mgr.list_checkpoints()] == [1]
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]


def test_keep_n_retention_and_pins(tmp_path):
    """keep_n=2 keeps the two newest; a pinned checkpoint survives a
    prune."""
    tt, mgr = _trained(tmp_path, steps=(1, 2, 3), keep_n=2)
    assert [s for s, _ in mgr.list_checkpoints()] == [2, 3]
    old = mgr.list_checkpoints()[0][1]
    with mgr._pin(old):
        mgr.save(4, trainer=tt)
        assert [s for s, _ in mgr.list_checkpoints()] == [2, 3, 4]
    mgr.save(5, trainer=tt)
    assert [s for s, _ in mgr.list_checkpoints()] == [4, 5]


def test_async_thread_writer(tmp_path):
    """save(async_=True) returns before the publish; the next save or a
    restore waits for it; a crashed writer is reported and leaves the
    earlier checkpoint restorable."""
    tt, mgr = _trained(tmp_path, steps=(1,))
    want = {k: v.clone() for k, v in tt.params.items()}
    tt.step(X, Y)
    mgr.save(2, trainer=tt, async_=True)
    assert mgr.last_save["mode"] == "async"
    assert mgr.wait_for_async() is True
    assert [s for s, _ in mgr.list_checkpoints()] == [1, 2]
    tt.step(X, Y)
    with faults.inject("ckpt_async_crash"):
        mgr.save(3, trainer=tt, async_=True)
        with pytest.warns(UserWarning, match="failed and was dropped"):
            assert mgr.wait_for_async() is False
    assert [s for s, _ in mgr.list_checkpoints()] == [1, 2]
    fresh = _tt(_pair()[1])
    CheckpointManager(str(tmp_path)).restore(mgr.list_checkpoints()[0][1],
                                             trainer=fresh)
    for k, v in want.items():
        assert torch.equal(fresh.params[k], v)


def test_gluon_trainer_states_scaler_and_generators(tmp_path):
    """A gluon net + Trainer checkpoint: parameters, optimizer states, the
    AMP loss scaler's state and the CPU generator's state round-trip."""
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.amp.loss_scaler import LossScaler

    _, net = _pair()
    tr = mt.gluon.Trainer(net.collect_params(), "adam",
                          {"learning_rate": 0.01})
    tr._amp_loss_scaler = LossScaler(init_scale=2.0 ** 10)
    ce = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    with mt.autograd.record():
        loss = ce(net(torch.from_numpy(X)), torch.from_numpy(Y)).mean()
    loss.backward()
    tr.step(1)
    trandom.generator("cpu").manual_seed(7)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, net=net, trainer=tr)
    draws = torch.rand(3, generator=trandom.generator("cpu"))
    want = {k: v.clone() for k, v in net.collect_params().items()}
    states = tr.get_states_bytes()
    tr._amp_loss_scaler.loss_scale, tr._amp_loss_scaler._unskipped = 3.0, 5
    for p in net._param_objects().values():
        p.set_data(torch.zeros_like(p.data()))
    m = mgr.restore_latest(net=net, trainer=tr)
    assert m["loss_scaler"] == {"loss_scale": 1024.0, "unskipped": 0}
    assert tr._amp_loss_scaler.loss_scale == 1024.0
    assert tr.get_states_bytes() == states
    for k, v in net.collect_params().items():
        assert torch.equal(v, want[k])
    assert torch.equal(torch.rand(3, generator=trandom.generator("cpu")),
                       draws)


def test_pod_commit_raises_naming_item_12(tmp_path):
    """The pod commit is ported (it no longer raises): ``pod=`` and
    ``bind_pod`` attach a topology, and a trainer of one rank under a
    1-host pod saves and restores the ordinary way
    (tests/test_torch_pod.py drives the distributed commit itself)."""
    topo = tpar.PodTopology(1, 1)
    mgr = CheckpointManager(str(tmp_path), pod=topo)
    assert mgr._pod is topo and mgr.bind_pod(None) is mgr
    assert mgr.bind_pod(topo)._pod is topo
    tr = _tt(_pair()[1])
    tr.step(X, Y)
    path = mgr.save(1, trainer=tr)
    assert os.path.isfile(os.path.join(path, "manifest.json"))
    fresh = _tt(_pair()[1])
    assert mgr.restore_latest(trainer=fresh)["step"] == 1
    for k, v in tr.params.items():
        assert torch.equal(fresh.params[k], v)


def _gluon_step(net, tr, x=X, y=Y):
    ce = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    with mt.autograd.record():
        loss = ce(net(torch.from_numpy(x)), torch.from_numpy(y)).mean()
    loss.backward()
    tr.step(1)


@pytest.mark.parametrize("policy", ["raise", "skip_batch", "rollback"])
def test_sentinel_policies_on_a_nan_gradient(tmp_path, policy):
    """nan_grad poisons one gradient: 'raise' raises, 'skip_batch' skips
    the update, 'rollback' restores the last checkpoint and skips; the
    counters as mxnet_tpu names them."""
    _, net = _pair()
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    mgr = CheckpointManager(str(tmp_path))
    _gluon_step(net, tr)
    mgr.save(1, net=net, trainer=tr)
    saved = {k: v.clone() for k, v in net.collect_params().items()}
    HealthSentinel(policy=policy).attach(tr, net=net, checkpoint_manager=mgr)
    _gluon_step(net, tr)             # a healthy step moves the weights
    moved = {k: v.clone() for k, v in net.collect_params().items()}
    assert any(not torch.equal(moved[k], saved[k]) for k in saved)
    sentinel.reset_stats()
    with faults.inject("nan_grad"):
        if policy == "raise":
            with pytest.raises(NumericHealthError, match="non-finite"):
                _gluon_step(net, tr)
        else:
            _gluon_step(net, tr)
    st = sentinel.stats()
    assert st["sentinel_nonfinite"] == 1
    # the poisoned step's forward still moved BatchNorm's running
    # statistics; a rollback restores them too
    want = saved if policy == "rollback" else moved
    for k, p in net._param_objects().items():
        if policy == "rollback" or p.grad_req != "null":
            assert torch.equal(p.data(), want[k])
    assert st["health_skipped_steps"] == (policy != "raise")
    assert st["sentinel_rollbacks"] == (policy == "rollback")


def test_step_stall_rolls_back(tmp_path, monkeypatch):
    """hang_step under a 0.3 s step deadline: with a rollback sentinel the
    stall restores the checkpoint and skips the step (the crash report
    amended); without one it raises StallError."""
    monkeypatch.setenv("MXNET_TPU_TORCH_WATCHDOG_STEP_TIMEOUT", "0.3")
    monkeypatch.setenv("MXNET_TPU_TORCH_CRASH_DIR", str(tmp_path / "crash"))
    _, net = _pair()
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    with faults.inject("hang_step"), pytest.raises(watchdog.StallError):
        _gluon_step(net, tr)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, net=net, trainer=tr)
    saved = {k: v.clone() for k, v in net.collect_params().items()}
    HealthSentinel(policy="rollback").attach(tr, net=net,
                                             checkpoint_manager=mgr)
    watchdog.reset_stats()
    with faults.inject("hang_step"), \
            pytest.warns(UserWarning, match="rolled back"):
        _gluon_step(net, tr)
    assert watchdog.stats()["watchdog_rollbacks"] == 1
    for k, v in net.collect_params().items():
        assert torch.equal(v, saved[k])


def test_resharding_over_two_ranks(tmp_path):
    """Resharding through the manifest's logical shapes: a one-rank
    checkpoint restores onto {"dp": 1, "fsdp": 2} (dense weights split
    over fsdp) as each rank's shard of it, and the 2-rank trainer's
    checkpoint (a distributed commit, each rank its own host) restores
    onto one rank equal to the gathered state; both bitwise."""
    _, net = _pair()
    values = {k: v.detach().numpy().copy()
              for k, v in net.collect_params().items()}
    one = _tt(net)
    one.step(X, Y)
    one_dir, two_dir = str(tmp_path / "one"), str(tmp_path / "two")
    CheckpointManager(one_dir).save(1, trainer=one)
    one_params = {k: v.numpy().copy() for k, v in one.params.items()}
    out = ranks.run_ranks(ranks.checkpoint_reshard_rank, 2,
                          (one_dir, two_dir, values, X, Y),
                          tmp_path, timeout=120)
    for r in out:
        assert r["t"] == 1
        for k, got in r["restored"].items():
            want = one_params[k]
            if k.startswith("m_dense") and k.endswith("weight"):
                chunk = -(-want.shape[0] // 2)
                pad = np.concatenate([want, np.zeros(
                    (2 * chunk - want.shape[0],) + want.shape[1:],
                    want.dtype)])
                want = pad[r["index"] * chunk:(r["index"] + 1) * chunk]
            np.testing.assert_array_equal(got, want)
    fresh = _tt(_pair()[1])
    m = CheckpointManager(two_dir).restore_latest(trainer=fresh)
    assert m["step"] == 2 and m["mesh_axes"] == {"dp": 1, "fsdp": 2}
    for k, v in out[0]["full"].items():
        np.testing.assert_array_equal(fresh.params[k].numpy(), v)
    assert fresh.opt_state["t"] == 2

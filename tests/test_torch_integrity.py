"""The port's integrity layer (``mxnet_tpu_torch/resilience/integrity.py``)
against ``mxnet_tpu``'s, on the CPU.

The ``xsf32-v1`` fold is integer arithmetic: the port's plain version
(``fold_plain``, what ``fold_tree`` takes on a CPU tensor) and its host
fold are held bit-exact (no tolerance) to ``mxnet_tpu``'s ``fold_host``
and ``fold_tree`` on every dtype the fold takes. Then the step
fingerprint, the checkpoint-manifest record, the self-test and its
quarantine, the shadow replay audit's rollback, preemption, and the
serving audit. The CUDA fold kernel is held to the plain version on the
card (marked ``cuda``; ``chip_smoke.py`` phase b runs the same cases).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.resilience import integrity as jint  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import parallel as tpar  # noqa: E402
from mxnet_tpu_torch.resilience import (CheckpointManager,  # noqa: E402
                                        faults, integrity, watchdog)

RNG = np.random.RandomState(3)


@pytest.fixture(autouse=True)
def _no_stale_preemption():
    """A SIGTERM another test sent this process (a chained handler) must
    not drain this file's steps."""
    integrity.clear_preempt()
    yield


BF16 = RNG.randn(37).astype(np.float32)
LEAVES = {
    "float32": RNG.randn(7, 5).astype(np.float32),
    "float32_big": (RNG.randn(300) * 1e30).astype(np.float32),
    "float16": RNG.randn(33).astype(np.float16),
    "int8": RNG.randint(-128, 128, 19).astype(np.int8),
    "uint8": RNG.randint(0, 256, 12).astype(np.uint8),
    "int32_high": np.array([-1, -2, 2 ** 31 - 1, -2 ** 31], np.int32),
    "bool": RNG.rand(9) > 0.5,
    "empty": np.zeros((0, 3), np.float32),
}


def _torch_leaf(name):
    if name == "bfloat16":
        return torch.from_numpy(BF16).to(torch.bfloat16)
    return torch.from_numpy(LEAVES[name].copy())


def _jax_leaf(name):
    if name == "bfloat16":
        return jnp.asarray(BF16).astype(jnp.bfloat16)
    return jnp.asarray(LEAVES[name])


@pytest.mark.parametrize("name", list(LEAVES) + ["bfloat16"])
def test_fold_bit_exact_with_mxnet_tpu(name):
    """One leaf of each dtype (bf16 zero-extended from its 16 bits; int32
    words near 2^32, whose square a signed int64 would overflow): the
    port's plain fold, fold_tree and host fold equal mxnet_tpu's
    fold_host and traced fold_tree exactly."""
    t = {f"x:{name}": _torch_leaf(name)}
    j = {f"x:{name}": _jax_leaf(name)}
    want = jint.fold_host(j)
    assert int(jint.fold_tree(j)) == want
    assert integrity.as_uint32(integrity.fold_plain(t)) == want
    assert integrity.as_uint32(integrity.fold_tree(t)) == want
    assert integrity.fold_host(t) == want


def test_fold_of_a_whole_state_and_the_step_fold():
    t = {k: _torch_leaf(k) for k in list(LEAVES) + ["bfloat16"]}
    j = {k: _jax_leaf(k) for k in list(LEAVES) + ["bfloat16"]}
    assert integrity.as_uint32(integrity.fold_tree(t)) == jint.fold_host(j)
    params = {"w": _torch_leaf("float32"), "b": _torch_leaf("float16")}
    grads = {"w": _torch_leaf("float32_big")}
    jp = {k: v.numpy() for k, v in params.items()}
    jg = {k: v.numpy() for k, v in grads.items()}
    want = jint.step_fold_host(jp, jg)
    assert int(jint.step_fold(jp, jg)) == want
    assert integrity.as_uint32(integrity.step_fold(params, grads)) == want
    assert integrity.step_fold_host(params, grads) == want
    assert integrity.state_fingerprint(params) == jint.state_fingerprint(jp)
    # the empty state folds to the seed
    assert integrity.as_uint32(integrity.fold_tree({})) == \
        jint.fold_host({})


def test_eight_byte_leaves_raise_in_graph_and_fold_on_the_host():
    x = np.arange(5, dtype=np.int64)
    with pytest.raises(TypeError, match="in-graph"):
        integrity.fold_tree({"x": torch.from_numpy(x)})
    with pytest.raises(TypeError, match="in-graph"):
        integrity.fold_plain({"x": torch.from_numpy(x)})
    assert integrity.fold_host({"x": x}) == jint.fold_host({"x": x})


def test_a_table_that_a_capture_finds_is_never_evicted(monkeypatch):
    """A capture over leaves at their warm-up addresses (static gradients)
    finds the eager device table that warm-up made, and its graph reads
    that table at every replay: from then on it is pinned, so the eager
    tables of later layouts (more than the eager cap) do not evict it.
    The table logic runs here on CPU tensors, with the capture flag and
    pinned memory stubbed."""
    monkeypatch.setattr(integrity, "_TABLES", {})
    monkeypatch.setattr(integrity, "_SPARES", {})
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    cpu = torch.device("cpu")
    items = [("w", torch.zeros(64))]
    warm = integrity._table_for(items, cpu)
    assert not warm.pinned
    capturing[0] = True
    assert integrity._table_for(items, cpu) is warm and warm.pinned
    capturing[0] = False
    others = [[("x", torch.zeros(i + 1))]
              for i in range(integrity._TABLES_EAGER_CAP + 1)]
    for other in others:
        integrity._table_for(other, cpu)
    assert any(t is warm for t in integrity._TABLES.values())
    assert integrity._table_for(items, cpu) is warm


def test_manifest_fingerprint_round_trip():
    params = {"w": _torch_leaf("float32")}
    rec = integrity.manifest_fingerprint(params)
    assert rec == jint.manifest_fingerprint(
        {"w": LEAVES["float32"]})
    assert integrity.verify_manifest_fingerprint(rec, params)
    bad = {"w": params["w"].clone()}
    bad["w"].view(-1)[0] += 1.0
    assert not integrity.verify_manifest_fingerprint(rec, bad)
    assert integrity.verify_manifest_fingerprint({"algo": "other"}, bad)


def test_selftest_and_sticky_quarantine():
    integrity.reset_state()
    integrity.reset_stats()
    assert integrity.device_selftest(torch.device("cpu"))
    with faults.inject("sdc_device_sticky", times=None):
        assert not integrity.device_selftest(torch.device("cpu"))
    assert integrity.stats()["integrity_selftest_failures"] == 1
    integrity.quarantine_device(0)
    integrity.quarantine_device(0)
    assert integrity.quarantined_devices() == [0]
    assert integrity.stats()["integrity_quarantined"] == 1
    integrity.reset_state()
    assert integrity.quarantined_devices() == []


def _lm_trainer():
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    torch.manual_seed(0)
    net = transformer.transformer_lm(vocab=40, units=16, num_heads=2,
                                     num_layers=2, max_len=8, impl="flash",
                                     prefix="tlm_")
    net.initialize(ctx=mt.cpu(), generator=torch.Generator().manual_seed(1))
    return tpar.ShardedTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(),
                               "adam", {"learning_rate": 0.01},
                               mesh=tpar.create_mesh({"dp": 1}, [mt.cpu()]))


X = np.random.RandomState(0).randint(0, 40, (4, 8))
Y = (5 * X + 3) % 40


@pytest.fixture
def audited(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_TORCH_INTEGRITY_AUDIT_EVERY", "2")
    integrity.reset_stats()
    integrity.reset_state()
    faults.reset()
    yield
    faults.reset()
    integrity.reset_state()
    watchdog.reset_peers()


@pytest.mark.parametrize("kind", ["sdc_bitflip_param", "sdc_bitflip_grad"])
def test_audit_rolls_back_a_transient_bit_flip(audited, kind):
    """Steps 1-4 with an audit every 2 steps; one bit flipped on step 2
    (in a parameter after the update, or a gradient before it): the audit
    sees the mismatch, the self-test passes, the step rolls back and runs
    again, and the final parameters and fingerprint are bitwise an
    unfaulted run's."""
    runs = []
    for faulted in (False, True):
        tr = _lm_trainer()
        ctx = faults.inject(kind, at_step=1, times=1) if faulted else None
        if ctx:
            ctx.__enter__()
        try:
            for _ in range(4):
                tr.step(X, Y)
        finally:
            if ctx:
                ctx.__exit__(None, None, None)
        runs.append((tr.params, tr.last_fingerprint))
    st = integrity.stats()
    assert st["integrity_audit_mismatches"] == 1
    assert st["integrity_rollbacks"] == 1
    assert st["integrity_selftest_failures"] == 0
    assert runs[0][1] == runs[1][1]
    for k, v in runs[0][0].items():
        assert torch.equal(runs[1][0][k], v)


def test_audit_quarantines_a_sticky_device(audited):
    """sdc_device_sticky flips a parameter bit every step and corrupts the
    device's self-test: the audit quarantines the device and raises
    PeerLostError (the mesh shrink around it is not ported)."""
    tr = _lm_trainer()
    with faults.inject("sdc_device_sticky", times=None):
        tr.step(X, Y)
        with pytest.raises(watchdog.PeerLostError, match="quarantined"):
            tr.step(X, Y)
    assert integrity.quarantined_devices() == [0]


def test_preemption_checkpoints_and_resumes_bitwise(tmp_path):
    """request_preempt (SIGTERM's handler) or the preempt fault: the step
    finishes, the manager publishes an emergency checkpoint, Preempted
    (exit code 0) is raised; a fresh trainer restored from it continues
    bitwise."""
    integrity.reset_state()
    for how in ("request", "fault"):
        tr = _lm_trainer()
        mgr = CheckpointManager(str(tmp_path / how))
        tr.enable_recovery(mgr)
        tr.step(X, Y)
        if how == "request":
            integrity.request_preempt()
            with pytest.raises(integrity.Preempted) as e:
                tr.step(X, Y)
        else:
            with faults.inject("preempt"), \
                    pytest.raises(integrity.Preempted) as e:
                tr.step(X, Y)
        assert e.value.code == 0 and e.value.step == 2
        assert not integrity.preempt_requested()
        want = [float(tr.step(X, Y)) for _ in range(2)]
        fresh = _lm_trainer()
        assert CheckpointManager(str(tmp_path / how)).restore_latest(
            trainer=fresh)["step"] == 2
        assert [float(fresh.step(X, Y)) for _ in range(2)] == want


def test_preempt_handler_traps_sigterm():
    """SIGTERM sets the preemption notice. The handler chains whatever
    handler was installed before it (mxnet_tpu's too, in this process):
    both packages' notices are cleared after, or a later step of either
    would drain."""
    import signal

    integrity.reset_state()
    try:
        assert integrity.install_preempt_handler()
        os.kill(os.getpid(), signal.SIGTERM)
        assert integrity.preempt_requested()
    finally:
        integrity.clear_preempt()
        jint.clear_preempt()


def test_audit_serving_fails_a_lying_replica():
    class _Future:
        def __init__(self, out):
            self.out = out

        def result(self, timeout=None):
            return self.out

    class _Replica:
        def __init__(self, rid, out):
            self.rid, self.state, self.out = rid, "HEALTHY", out

        def submit(self, feeds):
            return _Future(self.out)

    class _Fleet:
        def __init__(self, reps):
            self.reps, self.failed = reps, []

        def replicas(self, model):
            return self.reps

        def fail_replica(self, rid, model, reason):
            self.failed.append((rid, reason))

    gold = [np.arange(4, dtype=np.float32)]
    liar = [gold[0].copy()]
    liar[0].view(np.uint32)[0] ^= 1
    fleet = _Fleet([_Replica(0, [torch.from_numpy(gold[0])]),
                    _Replica(1, liar)])
    assert integrity.audit_serving(fleet, {"x": 1}, gold) == [1]
    assert fleet.failed == [(1, "integrity_audit")]


@pytest.mark.cuda
def test_fold_kernel_matches_its_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fold kernel has no CPU mode)")
    leaves = {k: _torch_leaf(k).cuda() for k in list(LEAVES) + ["bfloat16"]}
    want = integrity.as_uint32(integrity.fold_plain(leaves))
    assert integrity.as_uint32(integrity.fold_tree(leaves)) == want
    assert integrity.fold_host({k: v.cpu() for k, v in leaves.items()}) \
        == want

"""Peer and host loss recovery of the port's ShardedTrainer on the CPU
(``mxnet_tpu/parallel/trainer.py:750-985``; ``mxnet_tpu``'s own drill:
``__graft_entry__.py:134-340``).

Each drill runs 4 gloo rank processes of the tiny LM (Adam, fsdp rules),
a checkpoint every 2 steps, the fingerprint and an audit every 2 steps,
and lets a fault kill processes at step 5: every rank of host 1
(``host_death``), of host 0, the coordinator (``coordinator_loss``), or
rank 3 of a job without a pod (``peer_death``). The survivors detect the
loss themselves (the dead pids' beats, or the collective that failed),
agree on it, shrink the mesh, rebuild their process groups, restore the
step-4 checkpoint and go on to step 8. Their losses, fingerprints and
final parameters must equal, bitwise, a fresh job of as many ranks on the
shrunk axes that restores the same checkpoint and runs the same steps
(the shrunk-topology oracle). Without a manager, or with
``MXNET_TPU_TORCH_MESH_SHRINK=0``, the loss stays terminal; an audit whose
self-test fails on one rank excises that rank the same way.

Every spawned run of ranks has its own time limit
(``tests/_torch_ranks.py``).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mxnet_tpu_torch.resilience import faults  # noqa: E402

import _torch_ranks as ranks  # noqa: E402
from _torch_isolation import no_stale_preemption  # noqa: E402,F401

LM_DIMS = (1, 16, 2, 31, 8)     # layers, units, heads, vocab, max_len
STEPS, DIE_AT, B = 8, 5, 8
RANK_LIMIT = 120.0


def _values_and_batches():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    layers, units, heads, vocab, t = LM_DIMS
    torch.manual_seed(0)
    net = transformer.transformer_lm(vocab=vocab, units=units,
                                     num_heads=heads, num_layers=layers,
                                     max_len=t, impl="flash", prefix="tlm_")
    net.initialize(ctx=mt.cpu())
    values = {k: p.data().detach().numpy().copy()
              for k, p in net._param_objects().items()}
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(STEPS):
        x = rng.integers(0, vocab, (B, t)).astype(np.int64)
        batches.append((x, ((5 * x + 3) % vocab).astype(np.int64)))
    return values, batches


def _env(tmp_path, spec, **extra):
    env = {"MXNET_TPU_TORCH_HEARTBEAT_DIR": str(tmp_path / "hb"),
           "MXNET_TPU_TORCH_INTEGRITY_AUDIT_EVERY": "2",
           "MXNET_TPU_TORCH_WATCHDOG_COLLECTIVE_TIMEOUT": "30",
           "MXNET_TPU_TORCH_FAULTS": spec}
    env.update(extra)
    return env


def _drill_and_oracle(tmp_path, cfg, env, exits, restore_step=4):
    """The drill's survivors (by their new rank) and their oracle's
    ranks."""
    values, batches = _values_and_batches()
    out = ranks.run_ranks(ranks.pod_drill_rank, 4, (values, batches, cfg),
                          tmp_path / "drill", timeout=RANK_LIMIT, env=env,
                          exits=exits)
    survivors = sorted((r for r in out if r is not None),
                       key=lambda r: r["rank"])
    ocfg = dict(cfg, axes=survivors[0]["axes"], old_shards=4)
    oenv = {k: v for k, v in env.items() if "FAULT" not in k}
    oracle = ranks.run_ranks(
        ranks.pod_oracle_rank, len(survivors),
        (values, batches, ocfg, restore_step,
         [r["rows"][0] for r in survivors]),
        tmp_path / "oracle", timeout=RANK_LIMIT, env=oenv)
    return out, survivors, oracle


def _bitwise(survivors, oracle, restore_step=4):
    for got, want in zip(survivors, oracle):
        assert got["losses"][restore_step:] == want["losses"]
        assert got["fps"][restore_step:] == want["fps"]
        assert None not in want["fps"]
        for k, v in want["params"].items():
            assert got["params"][k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("kind,victims,first", [
    ("host_death", (2, 3), 0), ("coordinator_loss", (0, 1), 2)])
def test_host_loss_resumes_bitwise_as_its_shrunk_oracle(tmp_path, kind,
                                                        victims, first):
    """Over {"fsdp": 2, "dp": 2} each host is one fsdp slot, so each
    commit's shards are split between the hosts and the survivors read the
    dead host's back from disk. A host's death (host 1; or host 0, the
    coordinator: host 1 takes over, the rendezvous living in the job
    directory) shrinks fsdp to 1: two survivors, renumbered 0 and 1 at
    generation 1, equal to their oracle bitwise."""
    cfg = {"axes": {"fsdp": 2, "dp": 2}, "dims": LM_DIMS, "pod_hosts": 2,
           "ckpt": str(tmp_path / "ckpt"), "save_every": 2}
    out, survivors, oracle = _drill_and_oracle(
        tmp_path, cfg, _env(tmp_path, f"{kind}@{DIE_AT - 1}"),
        {v: faults.FAULT_EXIT_CODE for v in victims})
    assert [out[v] for v in victims] == [None, None]
    assert [r["rank0"] for r in survivors] == [first, first + 1]
    for r in survivors:
        assert r["axes"] == {"fsdp": 1, "dp": 2}
        assert r["generation"] == 1 and r["restored"] == 4
        assert r["shrinks"] == 1 and r["recoveries"] == 1
        assert r["pod"]["num_hosts"] == 1 and r["pod"]["this_host"] == 0
    _bitwise(survivors, oracle)


def test_peer_death_without_a_pod_shrinks_dp_and_benches_one(tmp_path):
    """Without a pod each rank is its own failure domain: rank 3's death
    shrinks {"dp": 4} to {"dp": 2}; rank 2, left out by the power-of-two
    rule, leaves the job with exit code 0; ranks 0 and 1 equal their
    oracle bitwise."""
    cfg = {"axes": {"dp": 4}, "dims": LM_DIMS, "pod_hosts": None,
           "ckpt": str(tmp_path / "ckpt"), "save_every": 2}
    out, survivors, oracle = _drill_and_oracle(
        tmp_path, cfg, _env(tmp_path, f"peer_death@{DIE_AT - 1}",
                            MXNET_TPU_TORCH_FAULT_PEER_RANK="3"),
        {3: faults.FAULT_EXIT_CODE, 2: 0})
    assert out[2] is None and out[3] is None
    assert [r["rank0"] for r in survivors] == [0, 1]
    for r in survivors:
        assert r["axes"] == {"dp": 2} and r["pod"] is None
        assert r["restored"] == 4 and r["shrinks"] == 1
    _bitwise(survivors, oracle)


@pytest.mark.parametrize("how", ["no_manager", "no_shrink"])
def test_peer_loss_stays_terminal_without_a_manager_or_shrink(tmp_path,
                                                              how):
    """The survivor's step raises PeerLostError (a StallError naming the
    dead rank) when there is no checkpoint manager to reload from, or the
    shrink is switched off."""
    values, batches = _values_and_batches()
    cfg = {"axes": {"dp": 2}, "dims": LM_DIMS, "pod_hosts": None,
           "ckpt": str(tmp_path / "ckpt"), "save_every": 1,
           "manager": how != "no_manager"}
    env = _env(tmp_path, "peer_death@1", MXNET_TPU_TORCH_FAULT_PEER_RANK="1")
    if how == "no_shrink":
        env["MXNET_TPU_TORCH_MESH_SHRINK"] = "0"
    out = ranks.run_ranks(ranks.peer_lost_terminal_rank, 2,
                          (values, batches[:3], cfg), tmp_path / "ranks",
                          timeout=RANK_LIMIT, env=env,
                          exits={1: faults.FAULT_EXIT_CODE})
    assert out[1] is None
    assert out[0]["error"] == "PeerLostError" and out[0]["stall"]
    assert out[0]["ranks"] == [1]


def test_audit_quarantine_excises_the_failed_rank(tmp_path):
    """``sdc_device_sticky`` on rank 0 (named by its rank when the job
    began): the audit at step 2 sees the global fingerprints disagree,
    every rank runs the self-test, the verdicts are all-reduced, and all
    raise PeerLostError naming rank 0; the recovery excises it (it leaves
    with exit code 0, as does rank 3, benched) and ranks 1 and 2 restore
    the step-1 checkpoint and go on, bitwise as their oracle."""
    cfg = {"axes": {"dp": 4}, "dims": LM_DIMS, "pod_hosts": None,
           "ckpt": str(tmp_path / "ckpt"), "save_every": 1, "keep_n": 8}
    env = _env(tmp_path, "sdc_device_sticky@0:*",
               MXNET_TPU_TORCH_FAULT_DEVICE="0")
    out, survivors, oracle = _drill_and_oracle(
        tmp_path, cfg, env, {0: 0, 3: 0}, restore_step=1)
    assert out[0] is None and out[3] is None
    assert [r["rank0"] for r in survivors] == [1, 2]
    for r in survivors:
        assert r["axes"] == {"dp": 2} and r["restored"] == 1
    _bitwise(survivors, oracle, restore_step=1)

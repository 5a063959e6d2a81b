"""The port's distributed kvstore (``mxnet_tpu_torch/kvstore/dist.py``) and
launcher (``mxnet_tpu_torch/kvstore/launch.py``) on 2 CPU workers over
gloo, after ``tests/test_dist.py``.

Each job runs this file as its worker (the ``__main__`` block, which
imports the port only). One job starts through the port's launcher, one
through the repo's ``tools/launch.py``: the DMLC_* protocol is the same.
Every subprocess has its own timeout. Tolerances: the store's values and
the ranks' weights are bitwise; a dist step against ``mxnet_tpu``'s
one-process step over both shards (carried weights) within 1e-5 of
max|w| (the sums run in other orders)."""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT = 120
BATCH = 4           # a worker's batch
STEPS = 3
LR = 0.1


def _net(lib):
    """A small ``cifar10_dist.py``-shaped net, widths deferred."""
    net = lib.gluon.nn.HybridSequential()
    net.add(lib.gluon.nn.Conv2D(8, 3, padding=1, activation="relu"),
            lib.gluon.nn.MaxPool2D(2),
            lib.gluon.nn.GlobalAvgPool2D(),
            lib.gluon.nn.Dense(10))
    return net


def _shard(rank, step):
    rng = np.random.RandomState(100 + 10 * rank + step)
    return (rng.rand(BATCH, 3, 8, 8).astype(np.float32),
            rng.randint(0, 10, BATCH).astype(np.float32))


# ----------------------------------------------------------------- workers
def _store_worker(mt, out):
    kv = mt.kv.create("dist_sync")
    rank, nw = kv.rank, kv.num_workers
    assert nw == int(os.environ["DMLC_NUM_WORKER"])
    res = {"nw": nw, "backend": kv.backend}
    with mt.cpu():
        kv.init("w", mt.nd.array(np.full(4, 7.0 if rank == 0 else -1.0)))
        w = mt.nd.zeros(4)
        kv.pull("w", out=w)
        res["init_val"] = w.asnumpy().copy()
        kv.push("g", mt.nd.array(np.full(3, rank + 1.0)))
        g = mt.nd.zeros(3)
        kv.pull("g", out=g)
        res["g_sum"] = g.asnumpy().copy()
        # a list push merges locally first, then across the workers
        kv.push("g", [mt.nd.array(np.full(3, 1.0)),
                      mt.nd.array(np.full(3, rank * 10.0))])
        kv.pull("g", out=g)
        res["g_list_sum"] = g.asnumpy().copy()
        kv.set_optimizer(mt.optimizer.SGD(learning_rate=0.1))
        kv.push("w", mt.nd.array(np.full(4, rank + 1.0)))
        kv.pull("w", out=w)
        res["w_after"] = w.asnumpy().copy()
        res["agree"] = kv.fingerprint_agree({"w": w})
        res["disagree"] = kv.fingerprint_agree(
            {"w": mt.nd.array(np.full(4, float(rank)))})
        res["fingerprint"] = kv.state_fingerprint({"w": w})
    kv.barrier()
    np.savez(os.path.join(out, f"store{rank}.npz"), **res)


def _train_worker(mt, out):
    kv = mt.kv.create("dist_sync")
    rank = kv.rank
    res = {}
    with mt.cpu():
        net = _net(mt)
        # each rank draws other weights: the trainer's init pull must
        # give every rank rank 0's
        net.initialize(mt.init.Xavier(), ctx=mt.cpu(),
                       generator=torch.Generator().manual_seed(rank))
        net(mt.nd.zeros((1, 3, 8, 8)))
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": LR}, kvstore=kv)
        loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        names = list(net.collect_params())
        # makes the store before the first forward: every rank pulls rank
        # 0's weights (the gradients pushed are the zero buffers)
        trainer.allreduce_grads()
        res.update({f"w0/{i}": net.collect_params()[n].detach().numpy()
                    .copy() for i, n in enumerate(names)})
        for step in range(STEPS):
            x, y = _shard(rank, step)
            with mt.autograd.record():
                loss = loss_fn(net(mt.nd.array(x)), mt.nd.array(y))
            loss.backward()
            trainer.step(BATCH)
            if step == 0:
                res.update({f"w1/{i}": net.collect_params()[n].detach()
                            .numpy().copy() for i, n in enumerate(names)})
        res.update({f"w/{i}": net.collect_params()[n].detach().numpy()
                    .copy() for i, n in enumerate(names)})
    np.savez(os.path.join(out, f"train{rank}.npz"), **res)


def _worker(mode, out):
    sys.path.insert(0, REPO)
    import mxnet_tpu_torch as mt

    {"store": _store_worker, "train": _train_worker}[mode](mt, out)
    print(f"{mode} rank {os.environ['DMLC_WORKER_ID']} done", flush=True)


# ------------------------------------------------------------------- tests
def _env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _launch(launcher, mode, tmp_path):
    cmd = [sys.executable, os.path.abspath(__file__), mode, str(tmp_path)]
    head = [sys.executable, "-m", "mxnet_tpu_torch.kvstore.launch"] \
        if launcher == "port" else \
        [sys.executable, os.path.join(REPO, "tools", "launch.py")]
    env = _env()
    env["MXNET_TPU_TORCH_DIST_CLAIM_DIR"] = str(tmp_path / "claims")
    r = subprocess.run(head + ["-n", "2"] + cmd, env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=JOB_TIMEOUT)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"


def test_store_across_two_workers(tmp_path):
    """init converges on rank 0's value, pushes are summed over the workers,
    the updater applies to the sum, the ranks agree bit for bit, and
    fingerprint_agree tells agreeing from disagreeing replicas."""
    _launch("port", "store", tmp_path)
    outs = [np.load(tmp_path / f"store{r}.npz") for r in range(2)]
    for o in outs:
        assert int(o["nw"]) == 2 and str(o["backend"]) == "gloo"
        np.testing.assert_array_equal(o["init_val"], np.full(4, 7.0))
        np.testing.assert_array_equal(o["g_sum"], np.full(3, 3.0))
        np.testing.assert_array_equal(o["g_list_sum"], np.full(3, 12.0))
        np.testing.assert_allclose(o["w_after"], np.full(4, 6.7), rtol=1e-6)
        assert bool(o["agree"]) and not bool(o["disagree"])
    np.testing.assert_array_equal(outs[0]["w_after"], outs[1]["w_after"])
    assert int(outs[0]["fingerprint"]) == int(outs[1]["fingerprint"])


def test_trainer_across_two_workers_via_tools_launch(tmp_path):
    """gluon.Trainer(kvstore=dist_sync) started by the repo's tools/launch.py:
    every rank starts from rank 0's weights and ends bitwise equal; the
    first dist step equals mxnet_tpu's one-process step over both shards
    with rescale 1 / (one worker's batch), from the same weights."""
    import mxnet_tpu as mx

    _launch("tools", "train", tmp_path)
    a, b = (np.load(tmp_path / f"train{r}.npz") for r in range(2))
    assert set(a.files) == set(b.files) and a.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    n = sum(k.startswith("w0/") for k in a.files)
    with mx.cpu():
        jnet = _net(mx)
        jnet.initialize(mx.initializer.Xavier())
        jnet(mx.nd.zeros((1, 3, 8, 8)))
        jparams = list(jnet.collect_params().values())
        assert len(jparams) == n
        for i, p in enumerate(jparams):
            p.set_data(mx.nd.array(a[f"w0/{i}"]))
        trainer = mx.gluon.Trainer(jnet.collect_params(), "sgd",
                                   {"learning_rate": LR})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        x = np.concatenate([_shard(r, 0)[0] for r in range(2)])
        y = np.concatenate([_shard(r, 0)[1] for r in range(2)])
        with mx.autograd.record():
            loss = loss_fn(jnet(mx.nd.array(x)), mx.nd.array(y))
        loss.backward()
        trainer.step(BATCH)
        for i, p in enumerate(jparams):
            want = p.data().asnumpy()
            np.testing.assert_allclose(
                a[f"w1/{i}"], want, rtol=0,
                atol=1e-5 * np.abs(want).max(), err_msg=f"param {i}")


def test_cifar_net_carries_mxnet_tpu_weights():
    """cifar10_dist.py's net (widths deferred in both packages) takes
    mxnet_tpu's weights by name through load_numpy_params; the logits and
    one Adam step of a one-process Trainer agree within 1e-5 of max."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt
    from mxnet_tpu.gluon import block as jblock
    from mxnet_tpu_torch.gluon import block as tblock

    rng = np.random.RandomState(3)
    x = rng.rand(8, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.float32)

    def net_of(lib):
        net = lib.gluon.nn.HybridSequential()
        net.add(lib.gluon.nn.Conv2D(32, 3, padding=1, activation="relu"),
                lib.gluon.nn.MaxPool2D(2), lib.gluon.nn.GlobalAvgPool2D(),
                lib.gluon.nn.Dense(10))
        return net

    out = {}
    params = None
    for lib in (mx, mt):
        jblock._BlockScope._global_counter.clear()
        tblock._BlockScope._global_counter.clear()
        with lib.cpu():
            net = net_of(lib)
            if lib is mx:
                net.initialize(mx.initializer.Xavier())
                net(mx.nd.array(x[:1]))
                params = {k: v.data().asnumpy()
                          for k, v in net.collect_params().items()}
            else:
                net.initialize(lib.init.Xavier(), ctx=lib.cpu())
                net.load_numpy_params(params)
            logits = net(lib.nd.array(x)).asnumpy()
            trainer = lib.gluon.Trainer(net.collect_params(), "adam",
                                        {"learning_rate": 0.002})
            loss_fn = lib.gluon.loss.SoftmaxCrossEntropyLoss()
            with lib.autograd.record():
                loss = loss_fn(net(lib.nd.array(x)), lib.nd.array(y))
            loss.backward()
            trainer.step(8)
            out[lib is mx] = (logits, [np.array(v.data().asnumpy() if lib
                                                 is mx else v.detach())
                                       for v in net.collect_params()
                                       .values()])
    (tl, tw), (jl, jw) = out[False], out[True]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5 * np.abs(jl).max())
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_update_on_kvstore_matches_the_trainers_update(optimizer):
    """Trainer(update_on_kvstore=True) on a dist store outside a job (one
    worker): the store runs the optimizer on its copy and the step pulls
    the weights, as the trainer's own sweep would update them."""
    import mxnet_tpu_torch as mt

    rng = np.random.RandomState(4)
    x = rng.rand(6, 5).astype(np.float32)
    y = rng.randint(0, 3, 6).astype(np.float32)
    weights = {}
    for on_kv in (False, True):
        with mt.cpu():
            net = mt.gluon.nn.Dense(3, in_units=5)
            net.initialize(mt.init.Xavier(), ctx=mt.cpu(),
                           generator=torch.Generator().manual_seed(0))
            trainer = mt.gluon.Trainer(
                net.collect_params(), optimizer, {"learning_rate": 0.1},
                kvstore="dist_sync", update_on_kvstore=on_kv)
            loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
            for _ in range(2):
                with mt.autograd.record():
                    loss = loss_fn(net(mt.nd.array(x)), mt.nd.array(y))
                loss.backward()
                trainer.step(6)
            weights[on_kv] = [t.detach().numpy().copy()
                              for t in net.collect_params().values()]
    for a, b in zip(weights[True], weights[False]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_config_errors_raise_before_the_handshake(tmp_path, monkeypatch):
    """Bad DMLC_* values and a rank claimed by a live process raise
    DistConfigError; dist_async raises."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.kvstore import dist

    monkeypatch.setenv("MXNET_TPU_TORCH_DIST_CLAIM_DIR", str(tmp_path))
    for env, match in (
            ({"DMLC_NUM_WORKER": "two"}, "not an integer"),
            ({"DMLC_NUM_WORKER": "0"}, "positive"),
            ({"DMLC_WORKER_ID": "2"}, "out of range"),
            ({"DMLC_PS_ROOT_PORT": "70000"}, "outside"),
            ({"DMLC_PS_ROOT_PORT": "x"}, "not an integer")):
        base = {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": "9",
                "DMLC_NUM_WORKER": "2", "DMLC_WORKER_ID": "0"}
        base.update(env)
        for k, v in base.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(dist.DistConfigError, match=match):
            dist.init_distributed()
    (tmp_path / "rank-1.claim").write_text(str(os.getppid()))
    with pytest.raises(dist.DistConfigError, match="already claimed"):
        dist.init_distributed("127.0.0.1:9", 2, 1)
    # a claim whose process is gone is replaced
    (tmp_path / "rank-0.claim").write_text("999999999")
    assert dist._claim_rank("127.0.0.1:9", 2, 0)
    assert (tmp_path / "rank-0.claim").read_text() == str(os.getpid())
    with pytest.raises(mt.MXNetError, match="asynchronous"):
        mt.kv.create("dist_async")


def test_launcher_tears_down_the_job_when_a_rank_fails():
    """The first failing rank's code is the job's, and its sibling is
    killed within the grace period instead of waiting."""
    body = ("import os, time; r = int(os.environ['DMLC_WORKER_ID']); "
            "assert os.environ['DMLC_NUM_WORKER'] == '2'; "
            "raise SystemExit(3) if r == 1 else time.sleep(60)")
    env = _env()
    env["MXNET_TPU_TORCH_LAUNCH_GRACE_S"] = "2"
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.kvstore.launch",
                        "-n", "2", sys.executable, "-c", body], env=env,
                       cwd=REPO, capture_output=True, text=True,
                       timeout=JOB_TIMEOUT)
    assert r.returncode == 3, r.stderr
    assert "worker rank 1 exited with code 3" in r.stderr
    assert time.monotonic() - t0 < 30


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])

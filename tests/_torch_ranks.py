"""Rank processes for the port's multi-rank tests (no test here).

:func:`run_ranks` spawns ``world`` processes with ``torch.multiprocessing``
(start method ``spawn``), each a rank of a gloo process group whose
rendezvous is a file under the test's ``tmp_path`` (``file://``), so
concurrent test workers never share a port. Every rank runs one of the
functions below on numpy inputs and pickles its numpy results into that
directory; the parent reads them back. A rank that raises fails the
call with its traceback, and the whole run has a time limit, after which
every rank is killed and the call raises ``TimeoutError``: a hung
rendezvous or collective fails the test instead of hanging it.

This module imports neither ``jax`` nor ``mxnet_tpu``: the spawned ranks
import it by name, and only the port.
"""
from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

JOIN_TIMEOUT = 60.0


def _entry(rank, fn, world, init_file, out_dir, args, env=None,
           hard_exit=False):
    import traceback

    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ["MXNET_TPU_TORCH_CAPTURE"] = "1"
    os.environ.update(env or {})
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        result = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if hard_exit:
            # a drill's survivors may hold process groups of a dead
            # generation whose destructors would wait on the dead
            import sys

            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(0 if os.path.exists(
                os.path.join(out_dir, f"rank{rank}.pkl")) else 1)
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world, args, tmp_path, timeout=JOIN_TIMEOUT, env=None,
              exits=None, hard_exit=None):
    """[result of rank 0, ..., rank world-1] of ``fn(rank, world, *args)``
    run in ``world`` spawned rank processes over gloo.

    ``env``: variables set in each rank before ``fn`` runs. ``exits``:
    {rank: exit code} of ranks that leave on purpose (a drill's victims, a
    benched survivor): their results are None, and a rank exiting with
    another code than its expected one (0 for the others) fails the
    call. ``hard_exit`` (default: when ``exits`` is given) ends each rank
    with ``os._exit`` after its result is written: a rank may hold process
    groups of a dead peer whose destructors would wait on it."""
    import torch.multiprocessing as mp

    out_dir = str(tmp_path)
    os.makedirs(out_dir, exist_ok=True)
    init_file = os.path.join(out_dir, "rendezvous")
    exits = dict(exits or {})
    if hard_exit is None:
        hard_exit = bool(exits)
    ctx = mp.start_processes(_entry, args=(fn, world, init_file, out_dir,
                                           args, env, hard_exit),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while any(p.exitcode is None for p in ctx.processes):
            for r, p in enumerate(ctx.processes):
                if p.exitcode is not None and \
                        p.exitcode != exits.get(r, 0):
                    err = os.path.join(out_dir, f"rank{r}.err")
                    tb = open(err).read() if os.path.exists(err) else ""
                    raise RuntimeError(
                        f"{fn.__name__}: rank {r} exited with code "
                        f"{p.exitcode} (expected {exits.get(r, 0)}):\n{tb}")
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{fn.__name__}: {world} ranks did not "
                                   f"finish within {timeout:.0f} s")
            time.sleep(0.05)
        for r, p in enumerate(ctx.processes):
            if p.exitcode != exits.get(r, 0):
                err = os.path.join(out_dir, f"rank{r}.err")
                tb = open(err).read() if os.path.exists(err) else ""
                raise RuntimeError(
                    f"{fn.__name__}: rank {r} exited with code "
                    f"{p.exitcode} (expected {exits.get(r, 0)}):\n{tb}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    results = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.pkl")
        if r in exits and not os.path.exists(path):
            results.append(None)
            continue
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


# ----------------------------------------------------------------- ranks
def _np(t):
    """A numpy copy (a CPU f32 tensor's .numpy() would share its memory,
    which later steps overwrite)."""
    return t.detach().float().cpu().numpy().copy()


def _cpu_mesh(world, axes):
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel

    return parallel.create_mesh(axes, [mt.cpu()] * world)


def ring_rank(rank, world, q, k, v, dout, cases):
    """For each (impl, causal) of ``cases``, this rank's block of the ring
    over {"sp": world}: its output, lse and the gradients of sum(out *
    dout) for its q, k and v blocks."""
    from mxnet_tpu_torch import parallel

    mesh = _cpu_mesh(world, {"sp": world})
    t = q.shape[2] // world
    sl = slice(rank * t, (rank + 1) * t)
    out = {}
    for impl, causal in cases:
        ins = [torch.tensor(a[:, :, sl], requires_grad=True)
               for a in (q, k, v)]
        parallel.ring.reset_stats()
        o, lse = parallel.ring_attention_inner(*ins, mesh, "sp",
                                               causal=causal, impl=impl,
                                               return_lse=True)
        (o * torch.tensor(dout[:, :, sl])).sum().backward()
        out[(impl, causal)] = {"out": _np(o), "lse": _np(lse),
                               "grads": [_np(a.grad) for a in ins],
                               "stats": parallel.ring.stats()}
    return out


def _lm(values, mesh, impl, remat, layers, units, heads, vocab, max_len):
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    net = transformer.transformer_lm(
        vocab=vocab, units=units, num_heads=heads, num_layers=layers,
        max_len=max_len, impl=impl, mesh=mesh, remat=remat, prefix="tlm_")
    net.initialize(ctx=mt.cpu())
    net.load_numpy_params(values)
    return net


def lm_ring_rank(rank, world, values, x, y, dims, remats):
    """For each remat of ``remats``, ShardedTrainer's loss and mean
    gradients of TransformerLM(impl='ring') over {"sp": world}: this rank
    holds every row and its slice of the tokens."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel

    mesh = _cpu_mesh(world, {"sp": world})
    t = x.shape[1] // world
    sl = slice(rank * t, (rank + 1) * t)
    out = {}
    for remat in remats:
        net = _lm(values, mesh, "ring", remat, *dims)
        tr = parallel.ShardedTrainer(
            net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1}, mesh=mesh)
        parallel.ring.reset_stats()
        loss, grads = tr._loss_and_mean_grads(tr._place(x[:, sl]),
                                              tr._place(y[:, sl]), 1)
        grads = tr._full(grads)
        out[remat] = {"loss": float(loss),
                      "grads": {k: _np(g) for k, g in grads.items()},
                      "stats": parallel.ring.stats()}
    return out


def _load_state(tr, params, aux, opt):
    """``tr`` given full-size numpy ``params``, ``aux`` and sgd momentum
    ``opt`` ({name: array}), each sharded parameter as this rank's shard."""
    with torch.no_grad():
        for src, dst in ((params, tr.params), (opt, tr.opt_state["state"])):
            for k, v in src.items():
                full = torch.tensor(v)
                if k in tr._shards:
                    sh = tr._shards[k]
                    full = sh.piece(full, tr.mesh.axis_index(sh.axes))
                dst[k].copy_(full)
        for k, v in aux.items():
            tr.aux[k].copy_(torch.tensor(v))


def trainer_rank(rank, world, model, values, opt, configs):
    """For each (name, axes, layout, steps) of ``configs``, ShardedTrainer
    over ``axes`` (batch axes dp[, fsdp]; fsdp rules from SpecLayout when
    ``layout``): for each step, the reference's state before it is loaded,
    one step taken on this rank's rows, and the loss, the full parameters
    (shards gathered), the running statistics and the momentum returned;
    with the bytes the rank holds."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel

    result = {}
    for name, axes, layout, steps in configs:
        mesh = _cpu_mesh(world, axes)
        if model["kind"] == "lm":
            net = _lm(values, mesh, "flash", None, *model["dims"])
        else:
            from mxnet_tpu_torch.gluon.model_zoo import vision

            zoo = vision.resnet
            net = zoo.ResNetV1(zoo.BottleneckV1, layout="NHWC", stem="s2d",
                               prefix="net_", **model["narrow"])
            net.initialize(ctx=mt.cpu())
            net.load_numpy_params(values)
        lay = parallel.SpecLayout.for_mesh(mesh)
        tr = parallel.ShardedTrainer(
            net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(opt),
            mesh=mesh, param_rules=lay.param_rules() if layout else (),
            batch_axis_name=lay.batch_axes())
        shards = mesh.axis_size(lay.batch_axes())
        me = mesh.axis_index(lay.batch_axes())
        out = []
        for st in steps:
            _load_state(tr, st["params"], st["aux"], st["opt"])
            tr.opt_state["t"] = st["t"]
            rows = st["x"].shape[0] // shards
            sl = slice(me * rows, (me + 1) * rows)
            loss = tr.step(st["x"][sl], st["y"][sl],
                           microbatches=st.get("microbatches"))
            full = tr._full(tr.params)
            mom = tr._full(tr.opt_state["state"])
            out.append({"loss": float(loss),
                        "params": {k: _np(v) for k, v in full.items()},
                        "aux": {k: _np(v) for k, v in tr.aux.items()},
                        "opt": {k: _np(v) for k, v in mom.items()}})
        held = {"params": sum(v.numel() * v.element_size()
                              for v in tr.params.values()),
                "opt": sum(v.numel() * v.element_size()
                           for v in tr.opt_state["state"].values())}
        result[name] = {"steps": out, "held": held}
    return result


def remat_rank(rank, world, values, x, y, dims):
    """Three fp32 SGD steps of the LM over {"dp": world} with remat off
    and on, from the same weights: (losses, params) for each."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel

    rows = x.shape[0] // world
    sl = slice(rank * rows, (rank + 1) * rows)
    got = {}
    for remat in (False, True):
        net = _lm(values, None, "flash", None, *dims)
        # the process group exists: for_multihost builds the mesh over it
        tr = parallel.ShardedTrainer.for_multihost(
            net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9}, axes={"dp": world},
            backend="gloo", devices=[mt.cpu()] * world, remat=remat)
        losses = [float(tr.step(x[sl], y[sl])) for _ in range(3)]
        got[remat] = (losses, {k: _np(v) for k, v in tr.params.items()})
    return got


def raises_rank(rank, world, values, dims, x=None, y=None):
    """The messages of a multi-rank trainer asked for what is not ported
    (a 'pp' axis of 2 ranks, 'tp' together with 'sp'), and what a trainer
    that keeps its checkpoint manager returns from a fingerprinted step
    over several ranks."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel

    net = _lm(values, None, "flash", None, *dims)
    loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    pp = _cpu_mesh(world, {"dp": 2, "pp": 2})
    sp_tp = _cpu_mesh(world, {"sp": 2, "tp": 2})
    cases = {
        "pp_axis": lambda: parallel.ShardedTrainer(net, loss, "sgd",
                                                   mesh=pp),
        "sp_tp": lambda: parallel.ShardedTrainer(
            net, loss, "sgd", mesh=sp_tp,
            param_rules=parallel.SpecLayout.for_mesh(sp_tp).param_rules()),
        "checkpoint_manager": lambda: _fingerprint_step(
            rank, world, net, loss, x, y),
    }
    out = {}
    for name, make in cases.items():
        try:
            out[name] = make()
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def _fingerprint_step(rank, world, net, loss, x, y):
    """A step with the fingerprint armed over {"dp": world}, by a trainer
    holding a checkpoint manager: the step and state fingerprints and the
    gathered parameters."""
    from mxnet_tpu_torch import parallel

    mgr = object()
    tr = parallel.ShardedTrainer(net, loss, "sgd",
                                 mesh=_cpu_mesh(world, {"dp": world}),
                                 checkpoint_manager=mgr)
    assert tr._ckpt_mgr is mgr
    rows = x.shape[0] // world
    sl = slice(rank * rows, (rank + 1) * rows)
    os.environ["MXNET_TPU_TORCH_INTEGRITY_FINGERPRINT"] = "1"
    try:
        tr.step(x[sl], y[sl])
    finally:
        del os.environ["MXNET_TPU_TORCH_INTEGRITY_FINGERPRINT"]
    return {"fp": tr.last_fingerprint, "state_fp": tr._state_fingerprint(),
            "params": {k: _np(v) for k, v in tr._full(tr.params).items()}}


def remat_and_raises_rank(rank, world, values, x, y, dims):
    """:func:`remat_rank` and :func:`raises_rank` in one run of ranks."""
    return {"remat": remat_rank(rank, world, values, x, y, dims),
            "raises": raises_rank(rank, world, values, dims, x, y)}


def _tp_step_runs(world, values, batches, dims, opt, axes, remat=None,
                  trainer_remat=False):
    """The LM over ``axes`` with SpecLayout's rules: ``len(batches)``
    chained steps on this rank's rows; the losses, the net's weights after
    sync_to_net, the replicated parameters as held, the bytes held per
    parameter and the collectives of the last step."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import collectives

    mesh = _cpu_mesh(world, axes)
    net = _lm(values, mesh, "flash", remat, *dims)
    lay = parallel.SpecLayout.for_mesh(mesh)
    tr = parallel.ShardedTrainer(
        net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(opt),
        mesh=mesh, param_rules=lay.param_rules(),
        batch_axis_name=lay.batch_axes(), remat=trainer_remat)
    shards = mesh.axis_size(lay.batch_axes())
    me = mesh.axis_index(lay.batch_axes())
    losses = []
    for x, y in batches:
        rows = x.shape[0] // shards
        sl = slice(me * rows, (me + 1) * rows)
        collectives.reset_stats()
        losses.append(float(tr.step(x[sl], y[sl])))
    stats = collectives.stats()
    tr.sync_to_net()
    held = tr.params
    return {"losses": losses,
            "net": {n: _np(p.data())
                    for n, p in net._param_objects().items()},
            "replicated": {k: _np(v) for k, v in held.items()
                           if k not in tr._shards and k not in tr._tp_split},
            "held": {k: v.numel() * v.element_size()
                     for k, v in held.items()},
            "opt_held": {k: v.numel() * v.element_size()
                         for k, v in tr.opt_state["state"].items()},
            "tp_split": sorted(tr._tp_split), "stats": stats}


def _tp_mlp_run(world, values, batches, opt, feat, hidden, classes):
    """The MLP (Dense relu, Dense) with every weight split over 'tp' by
    rows, over {"dp": 2, "tp": world // 2}: chained steps on this rank's
    rows; the losses and the weights after sync_to_net."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import nn

    mesh = _cpu_mesh(world, {"dp": 2, "tp": world // 2})
    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(nn.Dense(hidden, activation="relu", in_units=feat,
                         prefix="d0_"))
        net.add(nn.Dense(classes, in_units=hidden, prefix="d1_"))
    net.initialize(ctx=mt.cpu())
    net.load_numpy_params(values)
    tr = parallel.ShardedTrainer(
        net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(opt),
        mesh=mesh, param_rules=[(r".*_weight$",
                                 parallel.PartitionSpec("tp", None))])
    me = mesh.axis_index("dp")
    losses = []
    for x, y in batches:
        rows = x.shape[0] // 2
        losses.append(float(tr.step(x[me * rows:(me + 1) * rows],
                                    y[me * rows:(me + 1) * rows])))
    tr.sync_to_net()
    return {"losses": losses, "shards": sorted(tr._shards),
            "net": {n: _np(p.data())
                    for n, p in net._param_objects().items()}}


def _tp_products(rank, world, x, w1, b1, w2, b2, dy):
    """A column-parallel product, gelu, a row-parallel product over
    {"tp": world} on this rank's rows of w1 and b1 and columns of w2
    (tensor_parallel's f and g), and the same with g replaced by the
    BatchNorm all-reduce (whose backward sums the cotangents): the
    outputs, the gradients of sum(y * dy), and f's and g's counts."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.parallel import collectives, tensor_parallel as tp

    mesh = _cpu_mesh(world, {"tp": world})
    ctx = tp.TPContext(mesh, "tp", ())
    out = {}
    for name in ("g", "all_reduce_sum"):
        ins = [torch.tensor(a, requires_grad=True) for a in (
            x, np.split(w1, world)[rank], np.split(b1, world)[rank],
            np.split(w2, world, axis=1)[rank], b2)]
        xs, w1r, b1r, w2r, b2s = ins
        collectives.reset_stats()
        with tp.context(ctx):
            h = F.gelu(tp.column_parallel(xs, w1r, b1r), approximate="tanh")
            if name == "g":
                y = tp.row_parallel(h, w2r, b2s)
            else:
                y = collectives.all_reduce_sum_differentiable(
                    F.linear(h, w2r), mesh, "tp") + b2s
        (y * torch.tensor(dy)).sum().backward()
        out[name] = {"y": _np(y), "grads": [_np(a.grad) for a in ins],
                     "tp": collectives.stats()["tp"]}
    return out


def tensor_parallel_rank(rank, world, lm, mlp, unit):
    """The port's tensor parallelism in one run of ranks: the LM's steps
    over each mesh of ``lm["meshes"]``, with remat over the first; the
    width that tp does not split; the MLP; f and g on their own."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel

    values, batches, dims, opt = (lm[k] for k in ("values", "batches",
                                                   "dims", "opt"))
    out = {"lm": {}}
    for name, axes in lm["meshes"].items():
        out["lm"][name] = _tp_step_runs(world, values, batches, dims, opt,
                                        axes)
    first = next(iter(lm["meshes"].values()))
    out["remat"] = {
        "trainer": _tp_step_runs(world, values, batches, dims, opt, first,
                                 trainer_remat=True),
        "blocks": _tp_step_runs(world, values, batches, dims, opt, first,
                                remat=True)}
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    # num_heads of world / 2 over tp = world: the trainer refuses it
    _, units, _, vocab, max_len = dims
    mesh = _cpu_mesh(world, {"tp": world})
    narrow = transformer.transformer_lm(
        vocab=vocab, units=units, num_heads=world // 2, num_layers=1,
        max_len=max_len, impl="flash", prefix="narrow_")
    narrow.initialize(ctx=mt.cpu())
    try:
        parallel.ShardedTrainer(
            narrow, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            mesh=mesh,
            param_rules=parallel.SpecLayout.for_mesh(mesh).param_rules())
        out["narrow"] = None
    except ValueError as e:
        out["narrow"] = str(e)
    out["mlp"] = _tp_mlp_run(world, *mlp)
    out["products"] = _tp_products(rank, world, *unit)
    return out


def checkpoint_reshard_rank(rank, world, one_dir, two_dir, values, x, y):
    """The MLP of test_torch_checkpoint.py over {"dp": 1, "fsdp": world},
    its dense weights sharded over fsdp: two Adam steps on this rank's
    rows, saved to ``two_dir`` (a distributed commit, a rank a host); then
    the one-rank checkpoint in ``one_dir`` restored onto it. Returns the
    gathered state after the steps, this rank's restored shards and its
    fsdp index."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.resilience import CheckpointManager

    net = mt.gluon.nn.HybridSequential(prefix="m_")
    with net.name_scope():
        net.add(mt.gluon.nn.Dense(8, in_units=4, activation="relu"),
                mt.gluon.nn.BatchNorm(in_channels=8),
                mt.gluon.nn.Dense(3, in_units=8))
    net.initialize(ctx=mt.cpu())
    for name, p in net._param_objects().items():
        p.set_data(values[name])
    mesh = _cpu_mesh(world, {"dp": 1, "fsdp": world})
    tr = parallel.ShardedTrainer(
        net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 0.01}, mesh=mesh, batch_axis_name=("dp", "fsdp"),
        param_rules=[(r"m_dense\d_weight", parallel.PartitionSpec("fsdp"))])
    rows = x.shape[0] // world
    sl = slice(rank * rows, (rank + 1) * rows)
    for _ in range(2):
        tr.step(x[sl], y[sl])
    CheckpointManager(two_dir).save(2, trainer=tr)
    full = {k: _np(v) for k, v in tr._full(tr.params).items()}
    CheckpointManager(one_dir).restore_latest(trainer=tr)
    return {"full": full, "index": mesh.axis_index(("fsdp",)),
            "restored": {k: _np(v) for k, v in tr.params.items()},
            "t": tr.opt_state["t"]}


# ------------------------------------------------------------ pod drills
def _drill_trainer(values, cfg, mesh=None, pod=True):
    """The tiny LM's ShardedTrainer (Adam, fsdp rules from SpecLayout)
    over ``cfg["axes"]``: through ``for_pod`` with a pod, else
    ``for_multihost``; or over ``mesh``."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.resilience import CheckpointManager

    kw = dict(dtype=None)
    axes = dict(cfg["axes"])
    if mesh is None:
        mesh = parallel.create_mesh(axes, [mt.cpu()] * int(np.prod(list(
            axes.values())))) if not pod else None
    lay_mesh = mesh
    net = _lm(values, lay_mesh, "flash", None, *cfg["dims"])
    lay = parallel.SpecLayout(data_axis="dp" if "dp" in axes else None,
                              fsdp_axis="fsdp" if "fsdp" in axes else None,
                              tp_axis=None)
    mgr = CheckpointManager(cfg["ckpt"], keep_n=cfg.get("keep_n", 3)) \
        if cfg.get("manager", True) else None
    args = (net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
            {"learning_rate": 0.01})
    rules = dict(param_rules=lay.param_rules(),
                 batch_axis_name=lay.batch_axes(), checkpoint_manager=mgr,
                 **kw)
    if pod:
        topo = parallel.PodTopology.simulated(
            cfg["pod_hosts"], [mt.cpu()] * int(np.prod(list(axes.values()))))
        tr = parallel.ShardedTrainer.for_pod(*args, axes=axes,
                                             topology=topo, **rules)
        if mgr is not None:
            mgr.bind_pod(tr.pod)
    else:
        tr = parallel.ShardedTrainer(*args, mesh=mesh, **rules)
    return tr, mgr, lay


def _rows(mesh, lay, x, y):
    """This rank's rows of the global batch (by its index along the batch
    axes)."""
    shards = mesh.axis_size(lay.batch_axes())
    me = mesh.axis_index(lay.batch_axes())
    per = x.shape[0] // shards
    return x[me * per:(me + 1) * per], y[me * per:(me + 1) * per]


def pod_drill_rank(rank, world, values, batches, cfg):
    """One rank of a drill: steps 1..len(batches) of the tiny LM with a
    commit every ``cfg["save_every"]`` steps, the faults the environment
    arms killing a host, the coordinator or a peer on the way; each
    survivor feeds its own rows throughout. Returns the losses and
    fingerprints a step, the gathered parameters at the end, the mesh
    after and what the recovery reported."""
    import mxnet_tpu_torch  # noqa: F401  (arms MXNET_TPU_TORCH_FAULTS)
    from mxnet_tpu_torch.resilience import elastic, watchdog

    tr, mgr, lay = _drill_trainer(values, cfg,
                                  pod=cfg.get("pod_hosts") is not None)
    first_mesh = tr.mesh
    x0, y0 = _rows(first_mesh, lay, batches[0][0], batches[0][1])
    out = {"losses": [], "fps": [], "rank0": rank,
           "rows": [int(first_mesh.axis_index(lay.batch_axes()))]}
    for s, (x, y) in enumerate(batches, 1):
        xr, yr = _rows(first_mesh, lay, x, y)
        loss = tr.step(xr, yr)
        out["losses"].append(float(loss))
        out["fps"].append(tr.last_fingerprint)
        if mgr is not None and s % cfg["save_every"] == 0:
            mgr.save(s, trainer=tr)
    full = tr._full(tr.params)
    out.update(params={k: _np(v) for k, v in full.items()},
               axes=dict(tr.mesh.shape), rank=tr.mesh.rank,
               generation=tr.mesh.generation,
               restored=None if tr.last_recovery is None
               else tr.last_recovery.get("step"),
               shrinks=elastic.stats()["elastic_mesh_shrinks"],
               recoveries=watchdog.stats()["watchdog_peer_recoveries"],
               pod=None if tr.pod is None else tr.pod.describe())
    return out


def pod_oracle_rank(rank, world, values, batches, cfg, restore_step, rows):
    """The shrunk-topology oracle: a fresh job of ``world`` ranks over
    ``cfg["axes"]`` restores checkpoint ``restore_step`` and runs the
    steps after it, rank i feeding the rows of the old mesh's batch index
    ``rows[i]`` (the survivor it stands for)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel

    axes = dict(cfg["axes"])
    mesh = parallel.create_mesh(axes, [mt.cpu()] * world)
    tr, mgr, lay = _drill_trainer(values, cfg, mesh=mesh, pod=False)
    mgr.restore(os.path.join(cfg["ckpt"], f"ckpt-{restore_step:08d}"),
                trainer=tr)
    tr._step_count = restore_step
    out = {"losses": [], "fps": []}
    old_shards = cfg["old_shards"]
    for x, y in batches[restore_step:]:
        per = x.shape[0] // old_shards
        i = rows[rank]
        xr, yr = x[i * per:(i + 1) * per], y[i * per:(i + 1) * per]
        out["losses"].append(float(tr.step(xr, yr)))
        out["fps"].append(tr.last_fingerprint)
    full = tr._full(tr.params)
    out["params"] = {k: _np(v) for k, v in full.items()}
    return out


def fingerprint_rank(rank, world, values, x, y, axes, dims):
    """The tiny LM over ``axes`` (fsdp rules from SpecLayout, so the
    31-row tables split with padding): this rank's step fingerprint and
    state fingerprint, and the gathered gradients of the step and
    parameters after it (to fold on the host)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel

    os.environ["MXNET_TPU_TORCH_INTEGRITY_FINGERPRINT"] = "1"
    mesh = _cpu_mesh(world, axes)
    net = _lm(values, mesh, "flash", None, *dims)
    lay = parallel.SpecLayout.for_mesh(mesh)
    tr = parallel.ShardedTrainer(
        net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 0.01}, mesh=mesh, param_rules=lay.param_rules(),
        batch_axis_name=lay.batch_axes())
    xr, yr = _rows(mesh, lay, x, y)
    _, grads = tr._loss_and_mean_grads(tr._place(xr), tr._place(yr), 1)
    grads = {k: _np(v) for k, v in tr._full(grads).items()}
    tr.step(xr, yr)
    return {"fp": tr.last_fingerprint, "state_fp": tr._state_fingerprint(),
            "grads": grads,
            "params": {k: _np(v) for k, v in tr._full(tr.params).items()},
            "sharded": sorted(tr._shards)}


def _pod_mlp_trainer(values, ckpt_dir, pod_hosts=2):
    """The checkpoint tests' MLP from ``values``, over {"fsdp": world} as a
    pod of ``pod_hosts`` hosts, the dense weights split by rows (the 3-row
    one over 2 ranks with padding), its manager bound to the pod."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.resilience import CheckpointManager

    net = mt.gluon.nn.HybridSequential(prefix="m_")
    with net.name_scope():
        net.add(mt.gluon.nn.Dense(8, in_units=4, activation="relu"),
                mt.gluon.nn.BatchNorm(in_channels=8),
                mt.gluon.nn.Dense(3, in_units=8))
    net.initialize(ctx=mt.cpu())
    for name, p in net._param_objects().items():
        p.set_data(values[name])
    world = torch.distributed.get_world_size()
    topo = parallel.PodTopology.simulated(pod_hosts, [mt.cpu()] * world)
    mgr = CheckpointManager(ckpt_dir, pod=topo)
    tr = parallel.ShardedTrainer.for_pod(
        net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 0.01}, axes={"fsdp": world}, topology=topo,
        param_rules=[(r".*weight$", parallel.PartitionSpec("fsdp", None))],
        batch_axis_name="fsdp", checkpoint_manager=mgr)
    return tr, mgr


def pod_commit_rank(rank, world, values, x, y, ckpt_dir, partial_at=None):
    """A pod commit of the MLP after one step by ``world`` ranks (one a
    host); with ``partial_at``, the ``ckpt_partial_pod`` fault armed in
    rank 1 for the save of that step (a short commit timeout). Returns the
    gathered state, what each save did, and the files of the first."""
    from mxnet_tpu_torch.resilience import faults

    os.environ["MXNET_TPU_TORCH_CKPT_COMMIT_TIMEOUT_S"] = "3"
    tr, mgr = _pod_mlp_trainer(values, ckpt_dir)
    per = x.shape[0] // world
    xr, yr = x[rank * per:(rank + 1) * per], y[rank * per:(rank + 1) * per]
    tr.step(xr, yr)
    out = {"saves": {}}
    try:
        mgr.save(1, trainer=tr, async_=True)
        out["async"] = "saved"
    except ValueError as e:
        out["async"] = str(e)
    path = mgr.save(1, trainer=tr)
    out["files"] = sorted(os.listdir(os.path.join(path, "arrays")))
    out["last_save"] = dict(mgr.last_save)
    full = tr._full(tr.params)
    out["params"] = {k: _np(v) for k, v in full.items()}
    out["opt"] = {k: [_np(a) for a in v] for k, v in
                  tr._full_state({k: v[0] for k, v in
                                  tr.opt_state["state"].items()}).items()}
    out["aux"] = {k: _np(v) for k, v in tr.aux.items()}
    if partial_at is not None:
        tr.step(xr, yr)
        if rank == 1:
            faults.arm("ckpt_partial_pod")
        try:
            mgr.save(partial_at, trainer=tr)
            out["saves"][partial_at] = "published"
        except faults.SimulatedCrash:
            out["saves"][partial_at] = "crashed"
        except TimeoutError as e:
            out["saves"][partial_at] = f"timeout: {e}"
    return out


def pod_restore_rank(rank, world, values, ckpt_dir):
    """The MLP over {"fsdp": world} as a 2-host pod restoring the newest
    checkpoint in ``ckpt_dir``: its gathered parameters, moments and
    step count."""
    tr, mgr = _pod_mlp_trainer(values, ckpt_dir)
    manifest = mgr.restore_latest(trainer=tr)
    full = tr._full(tr.params)
    states = tr.opt_state["state"]
    m = tr._full_state({k: v[0] for k, v in states.items()})
    v = tr._full_state({k: v[1] for k, v in states.items()})
    return {"step": manifest["step"], "t": tr.opt_state["t"],
            "params": {k: _np(a) for k, a in full.items()},
            "m": {k: _np(a) for k, a in m.items()},
            "v": {k: _np(a) for k, a in v.items()},
            "aux": {k: _np(a) for k, a in tr.aux.items()}}


def peer_lost_terminal_rank(rank, world, values, batches, cfg):
    """:func:`pod_drill_rank` where the loss must stay terminal (no
    manager, or ``MXNET_TPU_TORCH_MESH_SHRINK=0``): the survivor's
    PeerLostError, as data."""
    from mxnet_tpu_torch.resilience import watchdog

    try:
        pod_drill_rank(rank, world, values, batches, cfg)
    except watchdog.PeerLostError as e:
        return {"error": type(e).__name__, "ranks": list(e.ranks),
                "stall": isinstance(e, watchdog.StallError),
                "message": str(e)}
    return {"error": None}


def dist_fault_rank(rank, world, mode):
    """The dist store under a fault (``mode``): ``hang`` -- rank 0's
    all-reduce wedged by ``hang_collective`` under a 1 s collective
    deadline; ``peer`` -- the last rank dies after joining and the others
    all-reduce; ``agree`` -- ``fingerprint_agree`` of values that differ on
    rank 1. Returns what each rank saw."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.observability import flight
    from mxnet_tpu_torch.resilience import faults, integrity, watchdog

    kv = mt.kv.create("dist_sync")
    out = {"rank": kv.rank, "workers": kv.num_workers}
    if mode == "agree":
        integrity.reset_stats()
        seq = flight.last_seq()
        named = {"w": np.full(4, 1.0 if rank != 1 else 2.0, np.float32)}
        out["agree"] = kv.fingerprint_agree(named)
        out["same"] = kv.fingerprint_agree({"w": np.ones(4, np.float32)})
        out["mismatches"] = integrity.stats()["integrity_ckpt_mismatches"]
        out["events"] = [e["op"] for e in flight.events("integrity",
                                                          since_seq=seq)]
        return out
    if mode == "peer" and rank == world - 1:
        os._exit(faults.FAULT_EXIT_CODE)
    if mode == "hang" and rank == 0:
        faults.arm("hang_collective")
    t0 = time.monotonic()
    try:
        kv.allreduce(torch.ones(4))
        out["error"] = None
    except watchdog.StallError as e:
        out.update(error=type(e).__name__,
                   ranks=list(getattr(e, "ranks", ())), phase=e.phase)
    out["seconds"] = time.monotonic() - t0
    # no survivor leaves before every survivor has seen the loss: a
    # survivor's exit would be a second death to the slower ones
    hb = os.environ["MXNET_TPU_TORCH_HEARTBEAT_DIR"]
    open(os.path.join(hb, f"seen{rank}"), "w").close()
    survivors = range(world - 1) if mode == "peer" else range(world)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not all(
            os.path.exists(os.path.join(hb, f"seen{r}")) for r in survivors):
        time.sleep(0.05)
    return out

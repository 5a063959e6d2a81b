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


def _entry(rank, fn, world, init_file, out_dir, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ["MXNET_TPU_TORCH_CAPTURE"] = "1"
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        result = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world, args, tmp_path, timeout=JOIN_TIMEOUT):
    """[result of rank 0, ..., rank world-1] of ``fn(rank, world, *args)``
    run in ``world`` spawned rank processes over gloo."""
    import torch.multiprocessing as mp

    out_dir = str(tmp_path)
    init_file = os.path.join(out_dir, "rendezvous")
    ctx = mp.start_processes(_entry, args=(fn, world, init_file, out_dir,
                                           args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{fn.__name__}: {world} ranks did not "
                                   f"finish within {timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
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


def raises_rank(rank, world, values, dims):
    """The messages of a multi-rank trainer asked for what is not ported:
    a 'pp' axis of 2 ranks, 'tp' together with 'sp', and a checkpoint
    manager."""
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
        "checkpoint_manager": lambda: parallel.ShardedTrainer(
            net, loss, "sgd", mesh=pp, checkpoint_manager=object()),
    }
    out = {}
    for name, make in cases.items():
        try:
            make()
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def remat_and_raises_rank(rank, world, values, x, y, dims):
    """:func:`remat_rank` and :func:`raises_rank` in one run of ranks."""
    return {"remat": remat_rank(rank, world, values, x, y, dims),
            "raises": raises_rank(rank, world, values, dims)}


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

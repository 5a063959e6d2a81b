"""The port's ``ShardedTrainer`` over several ranks against ``mxnet_tpu``'s
on the same mesh shape, on the CPU.

The port runs 4 rank processes over gloo (``tests/_torch_ranks.py``), each
given its rows of the global batch; ``mxnet_tpu`` runs its trainer on a
4-device CPU mesh in this process over the whole batch, GSPMD placing the
collectives. Two meshes: {"dp": 4} (replicated parameters, gradients
all-reduced) and {"dp": 2, "fsdp": 2} with ``SpecLayout.for_mesh(mesh)
.param_rules()`` (parameters stored as fsdp shards, all-gathered before
the forward, gradients reduce-scattered), batch axes ``("dp", "fsdp")``.
Two models: a 2-layer, 64-unit, 4-head ``TransformerLM`` and the narrow
NHWC ResNet-50 v1 of ``test_torch_parallel.py``, whose BatchNorm must take
its moments over the global batch (8 images, 2 a rank), as ``mxnet_tpu``'s
sharded step does. Over {"dp": 4} the ResNet also steps with
``microbatches=2`` on batches of 16: microbatch i is slice i of the
global batch (8 images, 2 a rank), whose moments its BatchNorm takes, as
``mxnet_tpu``'s accumulating step slices it.

Three fp32 SGD-momentum steps; as in ``test_torch_parallel.py`` each step
starts from ``mxnet_tpu``'s state before it (parameters, running
statistics, momentum, loaded into every rank, sharded where the rules
shard). After each: the loss within 1e-5 relative, every parameter within
1e-5 of its largest value, and every running statistic and momentum within
1e-5 of ``max(1, max|ref|)``, the scale ``test_torch_parallel.py`` holds
them to: a momentum is a gradient's size, and the narrow ResNet's
gradients are ill-conditioned (over {"dp": 4} one BatchNorm beta's
momentum lies 1.07e-5 of its own largest value from ``mxnet_tpu``'s).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu.gluon.model_zoo import transformer as jzoo  # noqa: E402
from mxnet_tpu.gluon.model_zoo import vision as jvision  # noqa: E402

import _torch_ranks as ranks  # noqa: E402

WORLD = 4
STEPS = 3
TOL = 1e-5
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
LM_DIMS = (2, 64, 4, 32, 16)     # layers, units, heads, vocab, max_len
NARROW = dict(layers=[1, 1, 1, 1], channels=[8, 16, 32, 64, 128],
              classes=10)
MESHES = {"dp4": {"dp": 4}, "dp2_fsdp2": {"dp": 2, "fsdp": 2}}
# the ResNet also takes its steps as 2 microbatches over {"dp": 4}: slice
# i of the global batch is microbatch i, its BatchNorm moments over it;
# a batch of 16, so each slice's moments are over 8 images, as the other
# runs' are (axes, microbatches, rows)
MICROBATCHES = {"dp4_mb2": ({"dp": 4}, 2, 16)}
RUNS = {"lm": {k: (v, None, 8) for k, v in MESHES.items()},
        "resnet": {**{k: (v, None, 8) for k, v in MESHES.items()},
                   **MICROBATCHES}}
CONFIGS = [(m, k) for m in RUNS for k in RUNS[m]]


def _values(jnet, rng):
    """Seeded weights for ``jnet`` (set there too): weights ~ N(0,
    1/fan_in), gamma and running_var in [0.5, 1.5), the rest N(0,
    0.1^2)."""
    values = {}
    for name, p in jnet.collect_params().items():
        shape = p.shape
        if name.endswith("weight"):
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif name.endswith(("running_var", "gamma")):
            v = rng.rand(*shape) + 0.5
        else:
            v = rng.randn(*shape) * 0.1
        values[name] = v.astype(np.float32)
        p.set_data(mx.nd.array(values[name]))
    return values


def _jax_model(kind, rows=8):
    rng = np.random.RandomState(3)
    if kind == "lm":
        layers, units, heads, vocab, max_len = LM_DIMS
        mx.random.seed(3)
        jnet = jzoo.transformer_lm(vocab=vocab, units=units, num_heads=heads,
                                   num_layers=layers, max_len=max_len,
                                   impl="dense", prefix="tlm_")
        jnet.initialize(mx.initializer.Xavier())
        jnet(mx.nd.zeros((1, max_len)))
        values = _values(jnet, rng)
        batches = []
        for s in range(STEPS):
            r = np.random.RandomState(10 + s)
            x = r.randint(0, vocab, (8, max_len)).astype(np.int64)
            y = r.randint(0, vocab, (8, max_len)).astype(np.float32)
            batches.append((x, y))
        model = {"kind": "lm", "dims": LM_DIMS}
    else:
        zoo = jvision.resnet
        jnet = zoo.ResNetV1(zoo.BottleneckV1, layout="NHWC", stem="s2d",
                            prefix="net_", **NARROW)
        jnet.initialize(mx.init.Zero())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jnet(mx.nd.zeros((1, 3, 32, 32)))
        values = _values(jnet, rng)
        batches = []
        for s in range(STEPS):
            r = np.random.RandomState(20 + s)
            x = (r.rand(rows, 3, 32, 32) - 0.5).astype(np.float32)
            y = r.randint(0, NARROW["classes"], rows).astype(np.float32)
            batches.append((x, y))
        model = {"kind": "resnet", "narrow": NARROW}
    return jnet, values, batches, model


def _np(v):
    return np.array(v, np.float32, copy=True)


def _jax_state(jtr):
    return {"params": {k: _np(v) for k, v in jtr.params.items()},
            "aux": {k: _np(v) for k, v in jtr.aux.items()
                    if k != jpar.functional.RNG_KEY},
            "opt": {k: _np(v) for k, v in jtr.opt_state["state"].items()},
            "t": int(jtr.opt_state["t"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(model, mesh): (mxnet_tpu's states and losses, the ranks'
    results)}: mxnet_tpu's runs here, then one run of the ranks a model
    for both meshes."""
    out = {}
    for kind, runs_of in RUNS.items():
        configs, wants = [], {}
        for mesh_name, (axes, n_micro, rows) in runs_of.items():
            jnet, values, batches, model = _jax_model(kind, rows)
            mesh = jpar.create_mesh(axes, jax.devices()[:WORLD])
            lay = jpar.SpecLayout.for_mesh(mesh)
            jtr = jpar.ShardedTrainer(
                jnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                dict(OPT), mesh=mesh, param_rules=lay.param_rules(),
                batch_axis_name=lay.batch_axes())
            steps, want = [], []
            for x, y in batches:
                pre = _jax_state(jtr)
                pre.update(x=x, y=y, microbatches=n_micro)
                steps.append(pre)
                jx = x.astype(np.int32) if kind == "lm" else x
                loss = float(jtr.step(jx, y, microbatches=n_micro))
                want.append(dict(_jax_state(jtr), loss=loss))
            configs.append((mesh_name, axes, "fsdp" in axes, steps))
            wants[mesh_name] = want
        got = ranks.run_ranks(ranks.trainer_rank, WORLD,
                              (model, values, dict(OPT), configs),
                              tmp_path_factory.mktemp(kind))
        for mesh_name in runs_of:
            out[(kind, mesh_name)] = (wants[mesh_name],
                                      [r[mesh_name] for r in got])
    return out


def _close(got, want, what, floor=1e-30):
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"{what}: {err:.3e} of max|ref| {scale:.3e}"


@pytest.mark.parametrize("kind,mesh_name", CONFIGS)
def test_steps_match_jax_on_the_same_mesh(runs, kind, mesh_name):
    want, got = runs[(kind, mesh_name)]
    for i, w in enumerate(want):
        for rank, res in enumerate(got):
            g = res["steps"][i]
            assert abs(g["loss"] - w["loss"]) <= TOL * abs(w["loss"]), \
                (i, rank, g["loss"], w["loss"])
            for part in ("params", "aux", "opt"):
                assert set(g[part]) == set(w[part]), part
                for k, v in w[part].items():
                    _close(g[part][k], v, f"step {i + 1} rank {rank} "
                                          f"{part} {k}",
                           1e-30 if part == "params" else 1.0)


@pytest.mark.parametrize("kind,mesh_name", CONFIGS)
def test_every_rank_holds_the_same_model(runs, kind, mesh_name):
    """Replicas agree bitwise: every rank's gathered parameters, running
    statistics and momentum after each step equal rank 0's."""
    _, got = runs[(kind, mesh_name)]
    for res in got[1:]:
        for g, g0 in zip(res["steps"], got[0]["steps"]):
            assert g["loss"] == g0["loss"]
            for part in ("params", "aux", "opt"):
                for k in g0[part]:
                    np.testing.assert_array_equal(g[part][k], g0[part][k])


@pytest.mark.parametrize("kind", ["lm", "resnet"])
def test_fsdp_holds_a_share_of_the_sharded_tables(runs, kind):
    """Over {"dp": 2, "fsdp": 2} a rank holds its half of every sharded
    table: for the LM every weight but the position table and the norms,
    so its parameters and momentum take well under the {"dp": 4} rank's;
    the ResNet's rules match no parameter (they name transformer tables),
    so it holds as much."""
    dp = runs[(kind, "dp4")][1][0]["held"]
    fsdp = runs[(kind, "dp2_fsdp2")][1][0]["held"]
    for part in ("params", "opt"):
        if kind == "lm":
            assert fsdp[part] < 0.6 * dp[part], (part, fsdp, dp)
        else:
            assert fsdp[part] == dp[part]


@pytest.fixture(scope="module")
def remat_and_raises(tmp_path_factory):
    """The ranks' remat steps and raise messages, in one run of them."""
    _, values, batches, _ = _jax_model("lm")
    x = np.concatenate([b[0] for b in batches])[:8]
    y = np.concatenate([b[1] for b in batches])[:8]
    return ranks.run_ranks(ranks.remat_and_raises_rank, WORLD,
                           (values, x, y, LM_DIMS),
                           tmp_path_factory.mktemp("remat_raises"))


def test_remat_steps_equal_steps_without_it(remat_and_raises):
    """remat=True recomputes the forward in the backward: in fp32 on the
    CPU the same operations on the same values, so three LM steps over
    {"dp": 4} (a trainer from for_multihost) give bitwise the same losses
    and weights."""
    for r in remat_and_raises:
        (l0, p0), (l1, p1) = r["remat"][False], r["remat"][True]
        assert l0 == l1 and l0[-1] < l0[0]
        for k in p0:
            np.testing.assert_array_equal(p1[k], p0[k])


def test_tensor_parallelism_and_checkpoint_manager_raise(remat_and_raises):
    """What is not ported raises, citing its ROADMAP item: a 'pp' axis
    and 'tp' together with 'sp' (item 6; tensor parallelism itself runs,
    test_torch_tensor_parallel.py). A trainer that keeps its checkpoint
    manager now takes the step fingerprint over several ranks: the same
    value on every rank, its state fingerprint mxnet_tpu's fold_host of
    the gathered parameters."""
    from mxnet_tpu.resilience import integrity as jintegrity

    fps = set()
    for r in remat_and_raises:
        r = r["raises"]
        assert "mesh axis 'pp' of size 2" in r["pp_axis"] and \
            "Queue 1 item 6" in r["pp_axis"]
        assert "'tp' of size 2 together with 'sp'" in r["sp_tp"] and \
            "Queue 1 item 6" in r["sp_tp"]
        got = r["checkpoint_manager"]
        assert got["state_fp"] == jintegrity.fold_host(
            {f"param:{k}": v for k, v in got["params"].items()})
        fps.add(got["fp"])
    assert len(fps) == 1 and None not in fps


# ------------------------------------------------- remat, one process
def test_remat_policies_resolve_as_jax_names_them():
    """The names the port maps exist in jax.checkpoint_policies; any other
    name raises ValueError with mxnet_tpu's text."""
    from mxnet_tpu import remat as jremat

    from mxnet_tpu_torch import remat as tremat

    for name in ("nothing_saveable", "everything_saveable", "dots_saveable",
                 "dots_with_no_batch_dims_saveable"):
        jremat.resolve_policy(name)
        tremat.resolve_policy(name)
    assert tremat.resolve_policy(True) is None
    assert tremat.resolve_policy(None) is None
    for bad in ("definitely_not_a_policy", "dots"):
        with pytest.raises(ValueError) as want:
            jremat.resolve_policy(bad)
        with pytest.raises(ValueError) as got:
            tremat.resolve_policy(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError):
        tremat.resolve_policy(3)


@pytest.mark.parametrize("policy", [True, "dots_saveable",
                                    "everything_saveable"])
def test_remat_blocks_give_the_same_gradients(policy):
    """TransformerLM(remat=policy): each block under activation
    checkpointing, recomputed in the backward outside autograd.record():
    the loss and every gradient bitwise those of the plain LM on the CPU."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    _, values, batches, _ = _jax_model("lm")
    x, y = (torch.tensor(a) for a in batches[0])
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    got = []
    for remat in (None, policy):
        layers, units, heads, vocab, max_len = LM_DIMS
        net = transformer.transformer_lm(
            vocab=vocab, units=units, num_heads=heads, num_layers=layers,
            max_len=max_len, impl="flash", remat=remat, prefix="tlm_")
        net.initialize(ctx=mt.cpu())
        net.load_numpy_params(values)
        with mt.autograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        got.append((loss.item(), {n: p.grad().clone() for n, p in
                                  net._param_objects().items()}))
    (l0, g0), (l1, g1) = got
    assert l0 == l1 and set(g0) == set(g1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_remat_recomputes_under_the_batch_norm_sync():
    """A Remat block's recomputation runs in the backward, after the
    multi-rank forward's ``sync_batch_stats`` scope has closed: it must
    take the forward's synchronization with it. Here the "other ranks"
    add fixed sums to BatchNorm's moments; the gradients through a Remat
    of the block equal those through the block itself."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon import contrib, nn
    from mxnet_tpu_torch.ops import nn as ops

    rng = np.random.RandomState(4)
    x = torch.tensor(rng.randn(4, 3, 5, 5).astype(np.float32))
    other = torch.tensor(rng.randn(2, 3).astype(np.float32) ** 2 * 4.0)
    w = rng.randn(2, 75).astype(np.float32)
    grads = []
    for wrap in (False, True):
        blk = nn.HybridSequential(prefix="b_")
        with blk.name_scope():
            blk.add(nn.BatchNorm(in_channels=3, prefix="bn_"))
            blk.add(nn.Dense(2, in_units=75, prefix="fc_"))
        blk.initialize(ctx=mt.cpu())
        blk.load_numpy_params({
            "b_bn_gamma": np.full(3, 1.5, np.float32),
            "b_bn_beta": np.full(3, 0.1, np.float32),
            "b_bn_running_mean": np.zeros(3, np.float32),
            "b_bn_running_var": np.ones(3, np.float32),
            "b_fc_weight": w,
            "b_fc_bias": np.zeros(2, np.float32)})
        net = contrib.nn.Remat(blk) if wrap else blk
        xi = x.clone().requires_grad_()
        with mt.autograd.record(), ops.sync_batch_stats(
                lambda t: t + other, 2):
            out = net(xi)
        (out * out).sum().backward()
        grads.append([xi.grad] + [p.grad().clone() for p in
                                  blk._param_objects().values()
                                  if p.grad_req != "null"])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

"""The port's tensor parallelism (``ShardedTrainer`` over a 'tp' axis)
against ``mxnet_tpu``'s on the same mesh, on the CPU.

The port runs 4 rank processes over gloo (``tests/_torch_ranks.py``), each
given its rows of the global batch; ``mxnet_tpu`` runs its trainer on 4
of the 8 virtual CPU devices in this process, GSPMD placing the
collectives. The LM (2 layers, 64 units, 4 heads, vocab 32, T 16) takes
``SpecLayout.for_mesh(mesh).param_rules()`` over {"dp": 1, "tp": 4},
{"fsdp": 2, "tp": 2} and {"dp": 2, "tp": 2}: its attention and FFN run
column- and row-parallel on each rank's shards, the embedding and the
head are held as shards and gathered. The MLP of ``mxnet_tpu``'s
``test_tp_matches_replicated`` splits every weight's rows over 'tp' on
{"dp": 2, "tp": 2}: gathered for use. Three chained SGD-momentum steps
from the same seeded weights; the losses within 1e-5 and the weights after
``sync_to_net`` within rtol 1e-4 / atol 1e-5, ``mxnet_tpu``'s own bounds
for its tensor-parallel step (``tests/test_parallel.py:111-116``).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu.gluon import nn as jnn  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import _torch_ranks as ranks  # noqa: E402
from test_torch_sharded import LM_DIMS, OPT, _jax_model, _values  # noqa: E402

from mxnet_tpu_torch.parallel import tensor_parallel as tp  # noqa: E402
from _torch_isolation import no_stale_preemption  # noqa: E402,F401

WORLD = 4
MESHES = {"dp1_tp4": {"dp": 1, "tp": 4},
          "fsdp2_tp2": {"fsdp": 2, "tp": 2},
          "dp2_tp2": {"dp": 2, "tp": 2}}
MLP = dict(feat=12, hidden=16, classes=8)
LOSS_RTOL, W_RTOL, W_ATOL = 1e-5, 1e-4, 1e-5
# the products' sums run in other orders (over the ranks' partial sums)
PRODUCT_TOL = 1e-5


def _jax_lm_run(axes):
    """mxnet_tpu's LM steps over ``axes``: (losses, weights after
    sync_to_net, values, batches)."""
    jnet, values, batches, _ = _jax_model("lm")
    mesh = jpar.create_mesh(axes, jax.devices()[:WORLD])
    lay = jpar.SpecLayout.for_mesh(mesh)
    jtr = jpar.ShardedTrainer(
        jnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(OPT),
        mesh=mesh, param_rules=lay.param_rules(),
        batch_axis_name=lay.batch_axes())
    losses = [float(jtr.step(x.astype(np.int32), y)) for x, y in batches]
    jtr.sync_to_net()
    weights = {k: np.array(p.data().asnumpy(), copy=True)
               for k, p in jnet.collect_params().items()}
    return losses, weights, values, batches


def _jax_mlp_run():
    """mxnet_tpu's MLP, every weight's rows over 'tp', on {"dp": 2, "tp":
    2}: (losses, weights, values, batches)."""
    mx.random.seed(7)
    jnet = jnn.HybridSequential(prefix="mlp_")
    with jnet.name_scope():
        jnet.add(jnn.Dense(MLP["hidden"], activation="relu", prefix="d0_"))
        jnet.add(jnn.Dense(MLP["classes"], prefix="d1_"))
    jnet.initialize(mx.initializer.Xavier())
    jnet(mx.nd.zeros((8, MLP["feat"])))
    values = _values(jnet, np.random.RandomState(5))
    batches = []
    for s in range(3):
        r = np.random.RandomState(30 + s)
        batches.append((r.rand(8, MLP["feat"]).astype(np.float32),
                        r.randint(0, MLP["classes"], 8).astype(np.float32)))
    jtr = jpar.ShardedTrainer(
        jnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(OPT),
        mesh=jpar.create_mesh({"dp": 2, "tp": 2}, jax.devices()[:WORLD]),
        param_rules=[(r".*_weight$", JP("tp", None))])
    losses = [float(jtr.step(x, y)) for x, y in batches]
    jtr.sync_to_net()
    weights = {k: np.array(p.data().asnumpy(), copy=True)
               for k, p in jnet.collect_params().items()}
    return losses, weights, values, batches


def _unit_operands():
    r = np.random.RandomState(9)
    return [r.randn(*shape).astype(np.float32) for shape in (
        (3, 4, 8), (16, 8), (16,), (8, 16), (8,), (3, 4, 8))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """mxnet_tpu's runs here, then one run of the ranks for everything."""
    want = {name: _jax_lm_run(axes) for name, axes in MESHES.items()}
    _, _, values, batches = want["dp1_tp4"]
    mlp_want = _jax_mlp_run()
    lm = {"values": values, "batches": batches, "dims": LM_DIMS,
          "opt": dict(OPT), "meshes": MESHES}
    mlp = (mlp_want[2], mlp_want[3], dict(OPT), MLP["feat"], MLP["hidden"],
           MLP["classes"])
    got = ranks.run_ranks(ranks.tensor_parallel_rank, WORLD,
                          (lm, mlp, _unit_operands()),
                          tmp_path_factory.mktemp("tp"), timeout=180)
    return {"lm": want, "mlp": mlp_want, "ranks": got}


def _spec_of(name, mesh):
    for pat, spec in jpar.SpecLayout.for_mesh(mesh).param_rules():
        if re.match(pat, name):
            return spec
    return JP()


def _split_count(spec, mesh):
    """How many ways ``spec`` splits a parameter over ``mesh``."""
    n = 1
    for e in spec:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            n *= mesh.shape[a]
    return n


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_lm_steps_match_jax_on_the_same_mesh(runs, mesh_name):
    losses, weights, _, _ = runs["lm"][mesh_name]
    for rank, res in enumerate(runs["ranks"]):
        got = res["lm"][mesh_name]
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL,
                                   err_msg=f"rank {rank}")
        assert set(got["net"]) == set(weights)
        for k, v in weights.items():
            np.testing.assert_allclose(got["net"][k], v, rtol=W_RTOL,
                                       atol=W_ATOL,
                                       err_msg=f"rank {rank} {k}")
    # the transformer's projections ran tensor-parallel: their weights
    # and the column biases were held as tp shards
    split = runs["ranks"][0]["lm"][mesh_name]["tp_split"]
    assert len(split) == 6 * LM_DIMS[0], split
    assert all(re.search(r"(attn_qkv|attn_out|ff1|ff2)_weight$|"
                         r"(attn_qkv|ff1)_bias$", k) for k in split)


def test_tp_mlp_matches_jax_on_the_same_mesh(runs):
    losses, weights, _, _ = runs["mlp"]
    for rank, res in enumerate(runs["ranks"]):
        got = res["mlp"]
        assert got["shards"] == ["mlp_d0_weight", "mlp_d1_weight"]
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
        for k, v in weights.items():
            np.testing.assert_allclose(got["net"][k], v, rtol=W_RTOL,
                                       atol=W_ATOL,
                                       err_msg=f"rank {rank} {k}")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_every_rank_holds_the_same_replicated_parameters(runs, mesh_name):
    """The parameters that no rule splits (the norms, the position table,
    the row-parallel and head biases) are bitwise equal on every rank after
    the steps, and so is the net every rank syncs to."""
    got = [r["lm"][mesh_name] for r in runs["ranks"]]
    assert got[0]["replicated"]
    for res in got[1:]:
        assert res["losses"] == got[0]["losses"]
        for part in ("replicated", "net"):
            for k, v in got[0][part].items():
                np.testing.assert_array_equal(res[part][k], v, err_msg=k)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_a_rank_holds_its_share_of_each_sharded_table(runs, mesh_name):
    """A rank holds each parameter's bytes over the ranks its spec splits
    it across, and as much of its momentum: of the sharded tables, 1 / (tp
    x fsdp) (a quarter on {"dp": 1, "tp": 4} and {"fsdp": 2, "tp": 2},
    half on {"dp": 2, "tp": 2}), a little more where the column biases
    split over tp alone."""
    axes = MESHES[mesh_name]
    _, weights, _, _ = runs["lm"][mesh_name]
    mesh = jpar.create_mesh(axes, jax.devices()[:WORLD])
    got = runs["ranks"][0]["lm"][mesh_name]
    sharded = full_sharded = 0
    for k, v in weights.items():
        parts = _split_count(_spec_of(k, mesh), mesh)
        assert got["held"][k] * parts == v.nbytes, (k, parts)
        assert got["opt_held"][k] == got["held"][k], k
        if parts > 1:
            sharded += got["held"][k]
            full_sharded += v.nbytes
    share = 1 / (axes["tp"] * axes.get("fsdp", 1))
    assert share <= sharded / full_sharded <= share + 0.01, \
        sharded / full_sharded


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_tp_layers_never_gather_their_weights(runs, mesh_name):
    """A step's all-gathers move the embedding and the head (gathered for
    use) and, under fsdp, each tp shard's fsdp pieces: never a
    transformer layer's weight at its full size. Each layer makes four tp
    all-reduces of its rows' activations, two in the forward (g) and two
    in the backward (f)."""
    axes = MESHES[mesh_name]
    _, weights, _, batches = runs["lm"][mesh_name]
    tpn, fsdp = axes["tp"], axes.get("fsdp", 1)
    want = 0
    for k, v in weights.items():
        if re.search(r"(embed|head)_weight$", k):
            want += v.nbytes
        elif re.search(r"(attn_qkv|attn_out|ff1|ff2)_weight$", k) and \
                fsdp > 1:
            want += v.nbytes // tpn
    layers, units = LM_DIMS[:2]
    rows = batches[0][0].shape[0] // (axes.get("dp", 1) * fsdp)
    act = rows * batches[0][0].shape[1] * units * 4
    for res in runs["ranks"]:
        stats = res["lm"][mesh_name]["stats"]
        assert stats["bytes_by_kind"]["all_gather"] == want
        for kind in ("copy_to_tp", "reduce_from_tp"):
            assert stats["tp"][kind] == {
                "tp": {"calls": 2 * layers, "bytes": 2 * layers * act}}


@pytest.mark.parametrize("variant", ["trainer", "blocks"])
def test_remat_tp_steps_equal_steps_without_it(runs, variant):
    """remat=True over {"dp": 1, "tp": 4}, on the trainer or on each
    block: the recomputation runs the same products and all-reduces
    again, in the same order on every rank, so the losses and weights are
    bitwise those of the steps without it."""
    for res in runs["ranks"]:
        plain, again = res["lm"]["dp1_tp4"], res["remat"][variant]
        assert again["losses"] == plain["losses"]
        # g's all-reduces run again in the recomputation (torch's
        # checkpoint stops recomputing a region once it holds every
        # tensor the backward saved, so a block may skip its last one)
        n, n0 = (r["stats"]["tp"]["reduce_from_tp"]["tp"]["calls"]
                 for r in (again, plain))
        assert n0 < n <= 2 * n0, (n, n0)
        for k, v in plain["net"].items():
            np.testing.assert_array_equal(again["net"][k], v, err_msg=k)


def test_heads_that_tp_does_not_split_raise(runs):
    for res in runs["ranks"]:
        msg = res["narrow"]
        assert msg is not None and "num_heads 2" in msg and \
            "tp = 4" in msg, msg


def test_column_and_row_parallel_products_match_one_rank(runs):
    """f and g on their own over {"tp": 4}: a column-parallel product,
    gelu and a row-parallel product on each rank's shards give the
    one-rank output and, pieced together, its gradients. With the
    BatchNorm all-reduce in g's place, whose backward sums the equal
    cotangents, the gradients of everything before it are 4x too large."""
    x, w1, b1, w2, b2, dy = (torch.tensor(a) for a in _unit_operands())
    ins = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    y = torch.nn.functional.linear(torch.nn.functional.gelu(
        torch.nn.functional.linear(ins[0], ins[1], ins[2]),
        approximate="tanh"), ins[3], ins[4])
    (y * dy).sum().backward()
    want = [a.grad.numpy() for a in ins]
    got = [r["products"] for r in runs["ranks"]]

    def close(a, b, what, scale=1.0):
        err = np.abs(a - scale * b).max() / np.abs(scale * b).max()
        assert err <= PRODUCT_TOL, f"{what}: {err:.2e}"

    pieces = [lambda g, r: g,
              lambda g, r: np.split(g, WORLD)[r],
              lambda g, r: np.split(g, WORLD)[r],
              lambda g, r: np.split(g, WORLD, axis=1)[r],
              lambda g, r: g]
    for rank, res in enumerate(got):
        g = res["g"]
        close(g["y"], y.detach().numpy(), f"rank {rank} y")
        for i, (piece, grad) in enumerate(zip(pieces, g["grads"])):
            close(grad, piece(want[i], rank), f"rank {rank} grad {i}")
        nbytes = x.numel() * 4
        assert g["tp"] == {"copy_to_tp": {"tp": {"calls": 1,
                                                 "bytes": nbytes}},
                           "reduce_from_tp": {"tp": {"calls": 1,
                                                     "bytes": nbytes}}}
        ctl = res["all_reduce_sum"]
        close(ctl["y"], y.detach().numpy(), f"rank {rank} control y")
        for i in range(4):
            close(ctl["grads"][i], pieces[i](want[i], rank),
                  f"rank {rank} control grad {i}", scale=WORLD)
        close(ctl["grads"][4], want[4], f"rank {rank} control grad b2")


@pytest.mark.parametrize("rows,units,tpn", [(192, 64, 4), (48, 8, 2),
                                            (12, 1, 4)])
def test_shard_qkv_holds_each_ranks_heads_and_gathers_back(rows, units,
                                                           tpn):
    """A rank's piece of a qkv projection's weight (or bias) holds the q,
    k and v rows of its heads, in that order, and the pieces in rank order
    give the full tensor back, bit for bit."""
    r = np.random.RandomState(rows)
    full = torch.tensor(r.randn(rows, units).astype(np.float32))
    if units == 1:
        full = full[:, 0]
    u = rows // 3
    pieces = [tp.shard_qkv(full, i, tpn) for i in range(tpn)]
    for i, p in enumerate(pieces):
        local = u // tpn
        for third in range(3):
            want = full[third * u + i * local:third * u + (i + 1) * local]
            assert torch.equal(p[third * local:(third + 1) * local], want)
    assert torch.equal(tp.gather_qkv(pieces), full)
    with pytest.raises(ValueError, match="do not split"):
        tp.shard_qkv(full[:rows - 1], 0, tpn)


def test_f_and_g_are_the_identity_outside_a_group():
    """Over an axis of one rank, f and g return their input, and a product
    outside a tp context raises."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.parallel import collectives, create_mesh

    mesh = create_mesh({"dp": 1, "tp": 1}, [mt.cpu()])
    x = torch.ones(2, 3)
    assert collectives.copy_to_tp(x, mesh, "tp") is x
    assert collectives.reduce_from_tp(x, mesh, "tp") is x
    with pytest.raises(RuntimeError, match="outside a tp context"):
        tp.column_parallel(x, torch.ones(4, 3))

"""The port's numerics tap (``mxnet_tpu_torch/observability/numerics.py``)
against ``mxnet_tpu``'s, on the CPU.

The stat columns (l2, maxabs, nonfinite, underflow, ratio) of the same
arrays are within 1e-6 of ``mxnet_tpu``'s ``graph_stats`` (relative to
max(|ref|, 1): f32 sums in another order; counts exact). On the port's
captured steps the tap picks between two programs per signature and its
stat selection is a slot: changing the cadence or the selection makes no
new program. The divergence conditions, the halt policy, the snapshots
and the ``numerics_*`` alert rules.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.observability import numerics as jnum  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import capture, parallel as tpar  # noqa: E402
from mxnet_tpu_torch.observability import alerts, numerics  # noqa: E402

TOL = 1e-6
RNG = np.random.RandomState(5)


def _arrays():
    g = RNG.randn(6, 4).astype(np.float32)
    g[0, 0] = np.nan
    g[1, 1] = 1e-9                      # flushes to zero in fp16
    pre = RNG.randn(6, 4).astype(np.float32)
    post = pre - 0.01 * RNG.randn(6, 4).astype(np.float32)
    act = np.maximum(RNG.randn(3, 5), 0).astype(np.float32)
    zero = np.zeros(7, np.float32)
    return g, pre, post, act, zero


@pytest.mark.parametrize("sel", [numerics.NUMERICS_STATS, ("l2", "ratio")])
def test_stat_columns_match_mxnet_tpu(sel):
    g, pre, post, act, zero = _arrays()
    mask = np.asarray([1.0 if s in sel else 0.0
                       for s in numerics.NUMERICS_STATS], np.float32)
    jt = jnum.NumericsTap(interval=1, policy="record")
    want = np.asarray(jt.graph_stats(
        [("w", jnp.asarray(g)), ("z", jnp.asarray(zero))],
        [("w", jnp.asarray(pre))], [("w", jnp.asarray(post))],
        [("a", jnp.asarray(act))], jnp.asarray(mask)))
    tt = numerics.NumericsTap(interval=1, policy="record")
    got = tt.graph_stats(
        [("w", torch.from_numpy(g)), ("z", torch.from_numpy(zero))],
        [("w", torch.from_numpy(pre))], [("w", torch.from_numpy(post))],
        [("a", torch.from_numpy(act))], torch.from_numpy(mask)).numpy()
    assert tt.rows == jt.rows
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    err = np.abs(got[ok] - want[ok]) / np.maximum(np.abs(want[ok]), 1.0)
    assert err.max() <= TOL


X = np.random.RandomState(0).randint(0, 40, (4, 8))
Y = (5 * X + 3) % 40


def _trainer():
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    net = transformer.transformer_lm(vocab=40, units=16, num_heads=2,
                                     num_layers=2, max_len=8, impl="flash",
                                     prefix="tlm_")
    net.initialize(ctx=mt.cpu(), generator=torch.Generator().manual_seed(1))
    return tpar.ShardedTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(),
                               "adam", {"learning_rate": 0.01},
                               mesh=tpar.create_mesh({"dp": 1}, [mt.cpu()]))


@pytest.fixture(autouse=True)
def _clean():
    numerics.reset()
    yield
    numerics.reset()


def test_tap_on_the_sharded_step_samples_on_cadence():
    """A tap every 3 steps through capture(trainer): samples at steps 1,
    4, 7; its rows are the trainer's gradients, pre-step params and
    updates; the param rows' l2 equal the pre-step params' norms; the
    update the step's; cadence and selection changes make no new
    program."""
    tr = _trainer()
    tap = numerics.NumericsTap(interval=3, policy="record")
    step = capture.capture(tr, numerics=tap)
    pre = None
    for i in range(7):
        if i == 6:
            pre = {k: v.clone() for k, v in tr.params.items()}
        step(X, Y)
    hist = numerics.history()
    assert [h["step"] for h in hist] == [1, 4, 7]
    last = hist[-1]["tensors"]
    assert len(last) == 3 * len(tr.params)
    for k, v in pre.items():
        assert abs(last[f"param:{k}"]["l2"] - float(v.norm())) <= \
            1e-5 * max(1.0, float(v.norm()))
        upd = (tr.params[k] - v).norm()
        assert abs(last[f"update:{k}"]["l2"] - float(upd)) <= \
            1e-5 * max(1.0, float(upd))
    programs = len(tr._exec.compiled_signatures)
    assert programs == 2          # with and without the tap
    tap.set_interval(1)
    tap.set_stats(("l2", "nonfinite"))
    step(X, Y)
    step(X, Y)
    assert len(tr._exec.compiled_signatures) == programs
    rows = numerics.history()[-1]["tensors"]
    assert all(set(r) == {"size", "l2", "nonfinite"} for r in rows.values())


def test_tap_on_the_gluon_captured_step():
    net = mt.gluon.nn.Dense(3, in_units=4, prefix="d_")
    net.initialize(ctx=mt.cpu())
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    ce = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    tap = numerics.NumericsTap(interval=2, policy="record")
    step = capture.capture(tr, net=net, loss_fn=lambda o, y: ce(o, y).mean(),
                           numerics=tap)
    x = torch.from_numpy(RNG.randn(8, 4).astype(np.float32))
    y = torch.from_numpy(RNG.randint(0, 3, 8).astype(np.float32))
    for _ in range(4):
        step(x, y)
    assert [h["step"] for h in numerics.history()] == [1, 3]
    assert set(numerics.history()[0]["grads"]) == {"d_weight", "d_bias"}


def test_halt_policy_and_the_nonfinite_condition(tmp_path):
    """A NaN weight under a halt-policy tap that samples every step:
    NumericsDivergenceError, the nonfinite condition active with a
    snapshot that load_snapshot reads back, and the numerics_nonfinite
    rule firing."""
    alerts.reset()
    tr = _trainer()
    tap = numerics.NumericsTap(interval=1, policy="halt",
                               snapshot_dir=str(tmp_path))
    tr.attach_numerics(tap)
    tr.step(X, Y)
    with torch.no_grad():
        tr.params["tlm_embed_weight"].view(-1)[0] = float("nan")
    with pytest.raises(numerics.NumericsDivergenceError):
        tr.step(X, Y)
    cond = numerics.condition("nonfinite")
    assert cond["active"] and cond["since_step"] == 2
    snap = numerics.load_snapshot(cond["snapshot"])
    assert snap["manifest"]["reason"] == "nonfinite"
    assert np.isnan(snap["params"]["tlm_embed_weight"]).any()
    assert snap["batch"][0].shape == X.shape
    alerts.evaluate(now=1000.0, force=True)
    assert alerts.get_rule("numerics_nonfinite").state in ("PENDING",
                                                           "FIRING")


def test_grad_explosion_and_dead_layer_conditions():
    tap = numerics.NumericsTap(interval=1, policy="record", dead_n=3)
    tap.rows = (("grad:a", 4), ("grad:b", 4))

    def sample(step, a, b):
        mat = np.zeros((2, len(numerics.NUMERICS_STATS)), np.float32)
        mat[:, 0] = (a, b)
        tap.on_step(step, None, mat)

    for s in range(10):
        sample(s, 1.0 + 0.01 * s, 1e-14)
    assert numerics.condition("dead_layer")["active"]
    assert numerics.condition("dead_layer")["evidence"]["dead_layers"] == \
        ["b"]
    assert not numerics.condition("grad_explosion")["active"]
    sample(11, 100.0, 1e-14)
    ev = numerics.condition("grad_explosion")
    assert ev["active"] and ev["evidence"]["grad_norm"] == pytest.approx(100)


def test_default_tap_follows_the_environment(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_TORCH_NUMERICS", raising=False)
    assert numerics.default_tap() is None
    monkeypatch.setenv("MXNET_TPU_TORCH_NUMERICS", "1")
    monkeypatch.setenv("MXNET_TPU_TORCH_NUMERICS_INTERVAL", "7")
    monkeypatch.setenv("MXNET_TPU_TORCH_NUMERICS_STATS", "l2,maxabs")
    tap = numerics.default_tap()
    assert tap.interval == 7 and tap.selected == ("l2", "maxabs")
    with pytest.raises(ValueError, match="unknown numerics stats"):
        numerics.NumericsTap(stats=("l3",))

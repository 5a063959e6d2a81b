"""The port's optimizer ops, optimizers (gluon) and functional optimizers
(``parallel.make_update_fn``) against mxnet_tpu's, on the CPU.

Every registered op takes the same seeded numpy inputs on both sides and
is held to mxnet_tpu's outputs and mutated slots; every optimizer runs 3
updates of two weights (gluon: through ``create`` + ``get_updater``;
functional: ``make_update_fn``'s ``update``) against mxnet_tpu's, within
rtol 1e-5 / atol 1e-6 in fp32 (f32 arithmetic in other orders: XLA fuses
and may reassociate). The fp16 ``multi_precision`` paths are held to
mxnet_tpu's fp32 path on the same values. Where mxnet_tpu differs from
MXNet the port follows MXNet, and a test of its own pins each difference
(ROADMAP Queue 3). SGLD's noise cannot be drawn alike (a JAX key against a
torch generator): the same noise is handed to both packages, and the
port's own draw is held to its mean and variance.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu.ops import registry as jreg  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import parallel as tpar  # noqa: E402
from mxnet_tpu_torch.ops import optimizer_ops as topt  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402
from mxnet_tpu_torch.optimizer import optimizer as toptim  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


# ------------------------------------------------------------- the ops
def _arrays(seed, kinds):
    """Seeded arrays by kind: r normal (3, 4), p positive, s small
    positive, h fp16 normal, m the fp32 copy of the last 'h', v a (4,)
    vector, 1 a one-element norm."""
    rng = np.random.RandomState(seed)
    out, last_h = [], None
    for k in kinds:
        if k == "r":
            a = rng.randn(3, 4).astype(np.float32)
        elif k == "p":
            a = (np.abs(rng.randn(3, 4)) + 0.5).astype(np.float32)
        elif k == "s":
            a = (rng.randn(3, 4) * 0.05).astype(np.float32)
        elif k == "h":
            a = last_h = rng.randn(3, 4).astype(np.float16)
        elif k == "m":
            a = last_h.astype(np.float32)
        elif k == "v":
            a = (np.abs(rng.randn(4)) + 0.1).astype(np.float32)
        elif k == "1":
            a = (np.abs(rng.randn(1)) + 0.5).astype(np.float32)
        elif k == "row":
            a = (np.abs(rng.randn(3)) + 0.1).astype(np.float32)
        out.append(a)
    return out


_COMMON = {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 0.3}
_MULTI = {"lrs": (0.1, 0.05), "wds": (0.01, 0.0), "rescale_grad": 0.5,
          "clip_gradient": 0.3, "num_weights": 2}
_LAMB = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6, "t": 3,
         "bias_correction": True, "wd": 0.01, "rescale_grad": 0.5,
         "clip_gradient": 0.3}
_MLAMB = {"num_tensors": 2, "learning_rates": (0.01, 0.02),
          "wds": (0.01, 0.0), "rescale_grad": 0.5, "clip_gradient": 0.3,
          "step_count": (1, 3), "lower_bound": 0.5, "upper_bound": 5.0}
OPS = [
    ("sgd_update", "rr", _COMMON),
    ("sgd_mom_update", "rrr", dict(_COMMON, momentum=0.9)),
    ("adam_update", "rrrp", dict(_COMMON, lr=0.01)),
    ("nag_mom_update", "rrr", dict(_COMMON, momentum=0.9)),
    ("mp_sgd_update", "hhm", _COMMON),
    ("mp_sgd_mom_update", ["h", "h", "r", "m"], dict(_COMMON, momentum=0.9)),
    ("mp_nag_mom_update", ["h", "h", "r", "m"], dict(_COMMON, momentum=0.9)),
    ("adamw_update", "rrrp", dict(_COMMON, lr=0.01, eta=0.5)),
    ("_mp_adamw_update", "hhrpm", dict(_COMMON, lr=0.01, eta=0.5)),
    ("ftrl_update", "rrrp", dict(_COMMON, lamda1=0.01, beta=1.0)),
    ("rmsprop_update", "rrp", dict(_COMMON, gamma1=0.9, epsilon=1e-8)),
    ("rmspropalex_update", "rrpsr", dict(_COMMON, gamma1=0.95, gamma2=0.9)),
    ("signsgd_update", "rr", _COMMON),
    ("signum_update", "rrr", dict(_COMMON, momentum=0.9, wd_lh=0.01)),
    ("ftml_update", "rrppr", {"lr": 0.01, "t": 3, "wd": 0.01,
                              "rescale_grad": 0.5, "clip_grad": 0.3}),
    ("lamb_update_phase2", "rr11", {"lr": 0.1, "lower_bound": 0.6,
                                    "upper_bound": 5.0}),
    ("mp_lamb_update_phase2", ["h", "r", "1", "1", "m"],
     {"lr": 0.1, "lower_bound": 0.6, "upper_bound": 5.0}),
    ("multi_lamb_update", "rrrp" * 2, _MLAMB),
    ("multi_lamb_update", "rrrp" * 2, dict(_MLAMB, bias_correction=False,
                                           lower_bound=-1.0)),
    ("all_finite", "rr", {}),
    ("multi_all_finite", "rr", {}),
    ("multi_sum_sq", "rr", {"num_arrays": 2}),
    ("multi_lars", "vvvv", {"eta": 0.001, "eps": 1e-8, "rescale_grad": 0.5}),
    ("reset_arrays", "rr", {}),
    ("multi_sgd_update", "rr" * 2, _MULTI),
    ("multi_sgd_mom_update", "rrr" * 2, dict(_MULTI, momentum=0.9)),
    ("multi_mp_sgd_update", "hhm" * 2, _MULTI),
    ("multi_mp_sgd_mom_update", ["h", "h", "r", "m"] * 2,
     dict(_MULTI, momentum=0.9)),
    ("preloaded_multi_sgd_update", "rr" * 2, "preloaded"),
    ("preloaded_multi_sgd_mom_update", "rrr" * 2, "preloaded_mom"),
    ("preloaded_multi_mp_sgd_update", "hhm" * 2, "preloaded"),
    ("preloaded_multi_mp_sgd_mom_update", ["h", "h", "r", "m"] * 2,
     "preloaded_mom"),
    ("_multi_adamw_update", "rrrp" * 2,
     dict(_MULTI, lrs=(0.01, 0.02), etas=(1.0, 0.5))),
    ("_multi_mp_adamw_update", "hhrpm" * 2,
     dict(_MULTI, lrs=(0.01, 0.02), etas=(1.0, 0.5))),
    ("_contrib_group_adagrad_update", ["r", "r", "row"],
     {"lr": 0.1, "epsilon": 1e-5, "rescale_grad": 0.5,
      "clip_gradient": 0.3}),
]


def _op_inputs(kinds, params, seed):
    arrays = _arrays(seed, list(kinds))
    if isinstance(params, str):        # preloaded: lrs, wds arrays last
        arrays += [np.array([0.1, 0.05], np.float32),
                   np.array([0.01, 0.0], np.float32)]
        params = {"num_weights": 2, "rescale_grad": 0.5,
                  "clip_gradient": 0.3,
                  **({"momentum": 0.9} if params.endswith("mom") else {})}
    return arrays, params


def _run_both(name, arrays, params):
    """mxnet_tpu's (primary outputs, {slot: new value}) and the port's
    (primary outputs, its input tensors after the in-place update)."""
    import jax.numpy as jnp

    jop = jreg.get_op(name)
    raw = jop.fn(*[jnp.asarray(a) for a in arrays], **params)
    raw = raw if isinstance(raw, tuple) else (raw,)
    n = jop.n_out(params)
    want = {slot: np.asarray(v, np.float32) for slot, v in
            zip(jop.mutate_slots(params), raw[n:])}
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    got = treg.get_op(name).fn(*ts, **params)
    got = got if isinstance(got, (tuple, list)) else (got,)
    return ([np.asarray(r, np.float32) for r in raw[:n]], want, list(got),
            ts)


@pytest.mark.parametrize("name,kinds,params", OPS,
                         ids=[f"{o[0]}{i}" for i, o in enumerate(OPS)])
def test_op_matches_mxnet_tpu(name, kinds, params):
    arrays, params = _op_inputs(kinds, params, seed=len(name))
    prim, want, got, ts = _run_both(name, arrays, params)
    half = any(a.dtype == np.float16 for a in arrays)
    # a 16-bit weight is its float32 master rounded once: within 1 ulp
    rtol = 2 ** -10 if half else RTOL
    for k, p in enumerate(prim):
        _close(got[k], p, rtol=rtol, what=f"{name} output {k}")
    for slot, v in want.items():
        _close(ts[slot], v, rtol=rtol, what=f"{name} slot {slot}")
    if name == "reset_arrays":
        assert all(not t.any() for t in ts)


def test_finite_ops_see_inf_and_nan():
    a = np.ones((3, 4), np.float32)
    for bad in (np.inf, -np.inf, np.nan):
        b = a.copy()
        b[1, 2] = bad
        for name in ("all_finite", "multi_all_finite"):
            _, _, got, _ = _run_both(name, [a, b], {})
            assert float(got[0]) == 0.0
    h = torch.ones(2, dtype=torch.float16) * 60000
    assert float(topt.multi_all_finite(h * 2)) == 0.0    # fp16 overflow


def test_every_optimizer_op_of_mxnet_tpu_is_registered():
    names = {o[0] for o in OPS} | {
        "_multi_mp_lamb_update", "lamb_update_phase1",
        "mp_lamb_update_phase1", "_sparse_adagrad_update"}
    for name in names:
        treg.get_op(name)
    for alias in ("_adamw_update", "mp_adamw_update", "_multi_lamb_update",
                  "multi_adamw_update", "multi_mp_adamw_update",
                  "group_adagrad_update", "adagrad_update"):
        treg.get_op(alias)


def test_sparse_adagrad_raises_naming_item_9():
    with pytest.raises(NotImplementedError, match="item 9"):
        treg.get_op("_sparse_adagrad_update").fn(torch.ones(2),
                                                 torch.ones(2),
                                                 torch.zeros(2))


# ------------------------------------- where the port follows MXNet
@pytest.mark.parametrize("name,kinds", [
    ("lamb_update_phase1", "rrrp"), ("mp_lamb_update_phase1", "hhrpm")])
def test_lamb_phase1_updates_the_moments_as_mxnet(name, kinds):
    """MXNet's phase 1 mutates mean and var (FMutateInputs {2, 3});
    mxnet_tpu's returns the direction and leaves them (ADVICE.md). The
    port's direction equals mxnet_tpu's, and its moments are the EMAs
    mxnet_tpu's own direction was computed from."""
    arrays = _arrays(3, list(kinds))
    params = dict(_LAMB)
    params.pop("clip_gradient")
    prim, want, got, ts = _run_both(name, arrays, params)
    assert not want                       # mxnet_tpu mutates nothing
    _close(got[0], prim[0], what="direction")
    g = arrays[1].astype(np.float32) * params["rescale_grad"]
    _close(ts[2], 0.9 * arrays[2] + 0.1 * g, what="mean")
    _close(ts[3], 0.999 * arrays[3] + 0.001 * g * g, what="var")
    assert not np.allclose(ts[2].numpy(), arrays[2])


def test_multi_mp_lamb_update_takes_five_tensors_a_weight():
    """MXNet's _multi_mp_lamb_update reads [w, g, mean, var, w32] a
    weight and steps the fp32 master; mxnet_tpu aliases the four-tensor op
    (ADVICE.md). The port's masters and moments equal mxnet_tpu's
    multi_lamb_update run on the fp32 masters; the fp16 weights are their
    rounding."""
    arrays = _arrays(5, list("hhrpm" * 2))
    params = dict(_MLAMB)
    masters = [arrays[5 * i + k] for i in range(2) for k in (4, 1, 2, 3)]
    masters[1] = masters[1].astype(np.float32)
    masters[5] = masters[5].astype(np.float32)
    _, want, _, _ = _run_both("multi_lamb_update", masters, params)
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    treg.get_op("_multi_mp_lamb_update").fn(*ts, **params)
    for i in range(2):
        for k_master, k_port in ((0, 4), (2, 2), (3, 3)):
            _close(ts[5 * i + k_port], want[4 * i + k_master],
                   what=f"weight {i} slot {k_port}")
        assert torch.equal(ts[5 * i], ts[5 * i + 4].half())


@pytest.mark.parametrize("bad", [np.inf, np.nan, 0.0])
@pytest.mark.parametrize("name,kinds", [
    ("adamw_update", "rrrp"), ("_mp_adamw_update", "hhrpm"),
    ("_multi_adamw_update", "rrrp" * 2),
    ("_multi_mp_adamw_update", "hhrpm" * 2)])
def test_adamw_family_skips_a_non_finite_rescale(name, kinds, bad):
    """MXNet's AdamW ops skip the whole update when the rescale they are
    handed (the loss scale) is not finite or is 0 (adamw-inl.h);
    mxnet_tpu's apply it (ADVICE.md), writing NaN or moving the moments.
    With a finite rescale tensor the two agree."""
    arrays = _arrays(7, list(kinds))
    multi = name.startswith("_multi")
    params = dict(_MULTI, lrs=(0.01, 0.02), etas=(1.0, 0.5)) if multi \
        else dict(_COMMON, lr=0.01, eta=0.5)
    params.pop("rescale_grad")

    def run(rs):
        rs_arr = np.array([rs], np.float32)
        if multi:
            return _run_both(name, arrays + [rs_arr], params)
        return _run_both_arr(name, arrays, params, rs_arr)

    _, want, _, ts = run(bad)
    for t, a in zip(ts, arrays):
        assert np.array_equal(t.numpy(), a, equal_nan=True)
    assert any(not np.array_equal(want[s], arrays[s].astype(np.float32),
                                  equal_nan=True) for s in want)
    prim, want, _, ts = run(0.5)
    for s, v in want.items():
        _close(ts[s], v, rtol=2 ** -10, what=f"slot {s}")


def _run_both_arr(name, arrays, params, rs_arr):
    """A single-weight AdamW op with its rescale as a tensor argument."""
    import jax.numpy as jnp

    jop = jreg.get_op(name)
    raw = jop.fn(*[jnp.asarray(a) for a in arrays],
                 rescale_grad_arr=jnp.asarray(rs_arr[0]), **params)
    n = jop.n_out(params)
    want = {slot: np.asarray(v, np.float32) for slot, v in
            zip(jop.mutate_slots(params), raw[n:])}
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    treg.get_op(name).fn(*ts, rescale_grad_arr=torch.tensor(rs_arr[0]),
                         **params)
    return [np.asarray(r) for r in raw[:n]], want, None, ts


def test_mp_sgd_counts_before_reading_the_rate():
    """mxnet_tpu's fp16 multi_precision SGD reads its rate before it
    counts the update (one update late); MXNet and the port count first,
    as mxnet_tpu's own fp32 path does: lr 1.0 halved at every update,
    three updates of a gradient of ones on a weight of ones."""
    def run(lib, dtype, mp, momentum):
        sched = lib.lr_scheduler.FactorScheduler(step=1, factor=0.5)
        opt = lib.optimizer.create("sgd", learning_rate=1.0,
                                   lr_scheduler=sched, momentum=momentum,
                                   multi_precision=mp)
        up = lib.optimizer.get_updater(opt)
        if lib is mx:
            w = mx.nd.array(np.ones(4), dtype=dtype)
            g = mx.nd.array(np.ones(4), dtype=dtype)
        else:
            w = torch.ones(4, dtype=getattr(torch, dtype))
            g = torch.ones(4, dtype=getattr(torch, dtype))
        for _ in range(3):
            up(0, g, w)
        return float(_np(w.asnumpy() if lib is mx else w)[0])

    for momentum in (0.0, 0.9):
        ref32 = run(mx, "float32", False, momentum)
        got = run(mt, "float16", True, momentum)
        assert abs(got - ref32) <= 2 ** -9 * abs(ref32), (momentum, got)
        assert run(mx, "float16", True, momentum) != pytest.approx(
            ref32, rel=1e-2)


# ------------------------------------------------ the gluon optimizers
GLUON = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
             "clip_gradient": 0.5}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("nag", {"learning_rate": 0.1, "wd": 0.01}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01}),
    ("adamw", {"learning_rate": 0.01, "wd": 0.01, "eta": 0.5}),
    ("adagrad", {"learning_rate": 0.1, "wd": 0.01, "clip_gradient": 0.5}),
    ("adadelta", {"wd": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "wd": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True}),
    ("ftrl", {"learning_rate": 0.1, "wd": 0.01}),
    ("adamax", {"wd": 0.01, "clip_gradient": 0.5}),
    ("nadam", {"wd": 0.01}),
    ("signum", {"learning_rate": 0.01, "wd": 0.01, "wd_lh": 0.01}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.0}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("dcasgd", {"learning_rate": 0.1}),
    ("ftml", {"learning_rate": 0.01, "wd": 0.01}),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01}),
    ("lamb", {"learning_rate": 0.01, "bias_correction": False,
              "lower_bound": 0.5, "upper_bound": 4.0,
              "clip_gradient": 0.5}),
    ("lars", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("lars", {"learning_rate": 0.1}),
    ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("test", {"rescale_grad": 0.5}),
]
SHAPES = [(3, 4), (5,)]


def _weights(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(dtype) for s in SHAPES]


def _grads(step, dtype=np.float32):
    rng = np.random.RandomState(100 + step)
    return [rng.randn(*s).astype(dtype) for s in SHAPES]


def _gluon_run(lib, name, kw, ws, grad_dtype=None):
    """3 updates of ``ws``; ``grad_dtype`` rounds the gradients to it and
    hands them over in the weights' dtype."""
    up = lib.optimizer.get_updater(lib.optimizer.create(name, **kw))
    if lib is mx:
        cells = [mx.nd.array(w, dtype=w.dtype) for w in ws]
    else:
        cells = [torch.from_numpy(w.copy()) for w in ws]
    for step in range(3):
        grads = [g.astype(ws[0].dtype) for g in
                 _grads(step, grad_dtype or ws[0].dtype)]
        for i, g in enumerate(grads):
            g = mx.nd.array(g, dtype=g.dtype) if lib is mx \
                else torch.from_numpy(g)
            up(i, g, cells[i])
    return up, [_np(c.asnumpy() if lib is mx else c) for c in cells]


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    return [_np(state.asnumpy() if hasattr(state, "asnumpy") else state)]


@pytest.mark.parametrize("name,kw", GLUON,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(GLUON)])
def test_gluon_optimizer_three_updates(name, kw):
    ws = _weights(1)
    jup, jws = _gluon_run(mx, name, kw, ws)
    tup, tws = _gluon_run(mt, name, kw, ws)
    for i, (a, b) in enumerate(zip(tws, jws)):
        _close(a, b, what=f"{name} weight {i}")
    for i in range(2):
        for a, b in zip(_leaves(tup.states[i]), _leaves(jup.states[i])):
            _close(a, b, what=f"{name} state {i}")
    assert tup.optimizer.num_update == jup.optimizer.num_update


@pytest.mark.parametrize("name,kw", GLUON,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(GLUON)])
def test_multi_precision_follows_the_fp32_path(name, kw):
    """fp16 weights with multi_precision: the fp32 masters after 3
    updates against mxnet_tpu's fp32 path on the same values (weights and
    gradients are fp16 numbers), the fp16 weights their rounding."""
    ws16 = _weights(2, np.float16)
    _, jws = _gluon_run(mx, name, kw, [w.astype(np.float32) for w in ws16],
                        grad_dtype=np.float16)
    tup, tws = _gluon_run(mt, name, dict(kw, multi_precision=True), ws16)
    for i in range(2):
        master = tup.states[i][1]
        assert master.dtype == torch.float32
        _close(master, jws[i], what=f"{name} master {i}")
        np.testing.assert_array_equal(tws[i], master.half().float().numpy())


def test_trainer_sweep_takes_each_optimizers_scalars():
    """gluon.Trainer's sweep (one update_group with n_scalars a weight) is
    the per-index update, for optimizers whose step count sets scalars of
    its own (LAMB 4, Nadam 7, FTML 4)."""
    for name, kw in (("lamb", {"learning_rate": 0.01}), ("nadam", {}),
                     ("ftml", {}), ("adamax", {})):
        net = mt.gluon.nn.Dense(3, in_units=4)
        net.initialize(mt.init.Xavier(), ctx=mt.cpu(),
                       generator=torch.Generator().manual_seed(0))
        ref = {k: v.detach().clone() for k, v in
               net.collect_params().items()}
        tr = mt.gluon.Trainer(net.collect_params(), name, dict(kw))
        up = mt.optimizer.get_updater(mt.optimizer.create(name, **kw))
        x = torch.randn(2, 4, generator=torch.Generator().manual_seed(1))
        for _ in range(3):
            with mt.autograd.record():
                loss = net(x).sum()
            loss.backward()
            grads = [p.grad().clone() for p in tr._params]
            tr.step(2)
            for i, g in enumerate(grads):
                name_i = list(ref)[i]
                up.optimizer.rescale_grad = 0.5
                up(i, g, ref[name_i])
        assert len(tr._scalars()) == 1 + 2 * tr.optimizer.n_scalars
        for k, v in net.collect_params().items():
            assert torch.equal(v, ref[k]), (name, k)


# --------------------------------------------- the functional optimizers
FUNCTIONAL = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
             "clip_gradient": 0.5}),
    ("adam", {"learning_rate": 0.01}),
    ("adamw", {"learning_rate": 0.01, "wd": 0.01, "eta": 0.5}),
    ("ftrl", {"wd": 0.01}),
    ("rmsprop", {"wd": 0.01}),
    ("rmsprop", {"centered": True, "clip_gradient": 0.5}),
    ("adagrad", {"wd": 0.01, "rescale_grad": 0.5}),
    ("adadelta", {"wd": 0.01, "learning_rate": 0.5}),
    ("adamax", {"wd": 0.01}),
    ("nadam", {"wd": 0.01}),
    ("ftml", {"wd": 0.01, "clip_gradient": 0.5}),
    ("signum", {"wd": 0.01, "wd_lh": 0.01}),
    ("signum", {"momentum": 0.0}),
    ("lamb", {"wd": 0.01}),
    ("lamb", {"bias_correction": False, "lower_bound": 0.5,
              "upper_bound": 4.0, "clip_gradient": 0.5}),
    ("lars", {"wd": 0.01}),
    ("dcasgd", {"momentum": 0.9, "wd": 0.01}),
    ("lbsgd", {"learning_rate": 0.1}),
]


def _functional_run(lib, name, kw, ws):
    init, update = lib.make_update_fn(name, dict(kw))
    if lib is jpar:
        import jax.numpy as jnp
        params = {str(i): jnp.asarray(w) for i, w in enumerate(ws)}
    else:
        params = {str(i): torch.from_numpy(w.copy())
                  for i, w in enumerate(ws)}
    state = init(params)
    for step in range(3):
        gs = _grads(step)
        if lib is jpar:
            grads = {str(i): jnp.asarray(g) for i, g in enumerate(gs)}
        else:
            grads = {str(i): torch.from_numpy(g) for i, g in enumerate(gs)}
        params, state = update(params, grads, state)
    return ({k: _np(np.asarray(v) if lib is jpar else v)
             for k, v in params.items()}, state)


@pytest.mark.parametrize("name,kw", FUNCTIONAL,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(FUNCTIONAL)])
def test_functional_optimizer_three_updates(name, kw):
    ws = _weights(3)
    jp, js = _functional_run(jpar, name, kw, ws)
    tp, ts = _functional_run(tpar, name, kw, ws)
    for k in jp:
        _close(tp[k], jp[k], what=f"{name} param {k}")
        for a, b in zip(_leaves(ts["state"][k]),
                        [_np(np.asarray(x)) for x in
                         _jleaves(js["state"][k])]):
            _close(a, b, what=f"{name} state {k}")
    assert ts["t"] == int(js["t"]) == 3


def _jleaves(s):
    if isinstance(s, (tuple, list)):
        return [x for y in s for x in _jleaves(y)]
    return [s]


def test_every_name_of_mxnet_tpus_registries_is_ported():
    from mxnet_tpu.parallel import optim as joptim
    from mxnet_tpu_torch.parallel import optim as toptim_f

    assert set(toptim_f.FUNCTIONAL_OPTIMIZERS) == set(
        joptim.FUNCTIONAL_OPTIMIZERS)
    jnames = set(mx.optimizer.optimizer._OPT_REGISTRY.keys())
    assert jnames <= set(toptim._REGISTRY), jnames - set(toptim._REGISTRY)


# --------------------------------------------------------------- SGLD
def test_sgld_with_the_same_noise_matches(monkeypatch):
    """Both packages handed the same noise: gluon and functional SGLD
    take the same 3 steps."""
    import jax
    import jax.numpy as jnp

    from mxnet_tpu import random as jrandom

    noise = [np.random.RandomState(50 + k).randn(*SHAPES[k % 2]).astype(
        np.float32) for k in range(6)]
    draws = iter(noise)
    monkeypatch.setattr(jrandom, "normal", lambda loc, scale, shape, **_:
                        mx.nd.array(next(draws) * scale))
    tdraws = iter(noise)
    monkeypatch.setattr(toptim, "_normal", lambda like, std, gen:
                        torch.from_numpy(next(tdraws)) * std)
    kw = {"learning_rate": 0.01, "wd": 0.01}
    ws = _weights(4)
    _, jws = _gluon_run(mx, "sgld", kw, ws)
    _, tws = _gluon_run(mt, "sgld", kw, ws)
    for a, b in zip(tws, jws):
        _close(a, b)
    # functional: the step's draws in parameter order
    fdraws = iter(noise)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype:
                        jnp.asarray(next(fdraws)))
    jp, _ = _functional_run(jpar, "sgld", kw, ws)
    tdraws = iter(noise)
    tp, _ = _functional_run(tpar, "sgld", kw, ws)
    for k in jp:
        _close(tp[k], jp[k])


def test_sgld_noise_has_the_langevin_mean_and_variance():
    """With a zero gradient a step moves each weight by N(0, lr): over
    200k weights the mean is within 5 standard errors of 0 and the
    variance within 2 % of lr; the same generator seed repeats it."""
    lr = 0.04
    w = torch.zeros(200_000)
    opt = mt.optimizer.create("sgld", learning_rate=lr,
                              generator=torch.Generator().manual_seed(0))
    opt.update(0, w, torch.zeros_like(w), None)
    assert abs(float(w.mean())) < 5 * math.sqrt(lr / w.numel())
    assert abs(float(w.var()) / lr - 1) < 0.02
    w2 = torch.zeros(200_000)
    mt.optimizer.create("sgld", learning_rate=lr,
                        generator=torch.Generator().manual_seed(0)).update(
        0, w2, torch.zeros_like(w2), None)
    assert torch.equal(w, w2)
    init, update = tpar.make_update_fn(
        "sgld", {"learning_rate": lr,
                 "generator": torch.Generator().manual_seed(1)})
    params = {"w": torch.zeros(200_000)}
    update(params, {"w": torch.zeros(200_000)}, init(params))
    assert abs(float(params["w"].var()) / lr - 1) < 0.02

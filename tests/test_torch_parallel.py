"""The port's ``parallel`` package (functional_call, make_update_fn,
create_mesh, ShardedTrainer) against ``mxnet_tpu``'s, on the CPU.

Both packages get the same numpy weights (``load_numpy_params``) and
batches. The net is the narrow ResNet-50 v1 of ``test_torch_vision.py``
(``BottleneckV1``, layers [1, 1, 1, 1], channels [8, 16, 32, 64, 128]) in
both layouts, trained as ``train_imagenet.py`` trains ResNet-50: SGD,
learning rate 0.1, momentum 0.9, wd 1e-4, on 8 images of 64x64 with
zero-mean pixels (uniform in [-0.5, 0.5), as a normalising input pipeline
gives them; BatchNorm's single-pass f32 moments lose digits to
E[x^2] - E[x]^2 where a channel's mean is large beside its spread, and
inputs in [0, 1) bring the loss of two f32 runs near 1e-5 apart).

Each of the trainer's steps starts from ``mxnet_tpu``'s state (params,
running statistics, momentum), copied into the port's trainer before it.
Chained on its own, this net does not keep two f32 runs together: BatchNorm
over few elements per channel, ReLU and max-pool make its gradient
ill-conditioned and, where a max-pool window holds a near tie, not even
continuous: runs of 3 steps from the same weights drift far past these
tolerances on some seeds, and on some batches ``mxnet_tpu``'s own f32
gradient at the first stages lies percents from a float64 run of the port,
whose f32 gradient stays close to it. One step from a shared state holds
the loss within 1e-5 relative and every param, running statistic and
momentum within 1e-4 of its scale (max(1, max|ref|)).

With lr 0.1 and wd 1e-4 a step moves a weight by 1e-5 of itself through wd,
below that tolerance. So the weight check also holds the part of each
step that is wd alone: the 1x1 convs' biases feed a BatchNorm, which
removes any per-channel constant, so their gradient is 0 up to rounding and
their momentum update ``momentum * m - m_new = lr * (g + wd * b)`` is
``lr * wd * b``. It must agree within 25 % of its largest value: the
rounding noise in those gradients comes near a tenth of ``wd * b`` at
stage 1 (sums over 2048 elements), and a trainer that leaves wd off gamma,
beta and the biases misses it by 100 %.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu.gluon.model_zoo import vision as jvision  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import parallel as tpar  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision  # noqa: E402
from mxnet_tpu_torch.ops import optimizer_ops as topt  # noqa: E402

NARROW = dict(layers=[1, 1, 1, 1], channels=[8, 16, 32, 64, 128],
              classes=10)
LAYOUTS = [("NHWC", "s2d"), ("NCHW", "conv7")]
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
BATCH, HW = 8, 64
LOSS_TOL = 1e-5
STATE_TOL = 1e-4
WD_TOL = 0.25


def _build(pkg, layout, stem):
    zoo = (jvision if pkg == "jax" else tvision).resnet
    return zoo.ResNetV1(zoo.BottleneckV1, layout=layout, stem=stem,
                        prefix="net_", **NARROW)


def _pair(layout, stem, seed=3):
    """mxnet_tpu's net and the port's with the same random weights: conv
    and dense weights ~ N(0, 1/fan_in), gamma and running_var in
    [0.5, 1.5), biases, beta and running_mean ~ N(0, 0.1^2)."""
    jnet = _build("jax", layout, stem)
    jnet.initialize(mx.init.Zero())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jnet(mx.nd.zeros((1, 3, HW, HW)))      # resolves deferred shapes
    rng = np.random.RandomState(seed)
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
    tnet = _build("torch", layout, stem)
    tnet.initialize(ctx=mt.cpu())
    tnet.load_numpy_params(values)
    return jnet, tnet, values


def _batch(seed=0, n=BATCH):
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, 3, HW, HW) - 0.5).astype(np.float32)
    y = rng.randint(0, NARROW["classes"], n).astype(np.float32)
    return x, y


def _trainers(jnet, tnet, opt=OPT, dtype=None, update=None):
    jtr = jpar.ShardedTrainer(
        jnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(opt),
        mesh=jpar.create_mesh({"dp": 1}, jax.devices()[:1]), dtype=dtype)
    ttr = tpar.ShardedTrainer(
        tnet, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(opt),
        mesh=tpar.create_mesh({"dp": 1}, [mt.cpu()]), dtype=dtype)
    if update is not None:
        ttr._update = update
    return jtr, ttr


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _jax_aux(jtr):
    return {k: v for k, v in jtr.aux.items() if k != jpar.functional.RNG_KEY}


def _load_jax_state(ttr, jtr):
    """Copy mxnet_tpu's trainer state into the port's trainer."""
    with torch.no_grad():
        for k, v in jtr.params.items():
            ttr.params[k].copy_(torch.tensor(_np(v)))
        for k, v in _jax_aux(jtr).items():
            ttr.aux[k].copy_(torch.tensor(_np(v)))
        for k, v in jtr.opt_state["state"].items():
            ttr.opt_state["state"][k].copy_(torch.tensor(_np(v)))
    ttr.opt_state["t"] = int(jtr.opt_state["t"])


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


def _check_state(ttr, jtr, mom_before, tol=STATE_TOL):
    """Every param, running statistic and momentum within ``tol`` of its
    scale, and the wd part of each conv bias's momentum update within
    WD_TOL (module docstring)."""
    for k, v in jtr.params.items():
        _close(ttr.params[k], v, tol, k)
    for k, v in _jax_aux(jtr).items():
        _close(ttr.aux[k], v, tol, k)
    mom = OPT["momentum"]
    for k, v in jtr.opt_state["state"].items():
        _close(ttr.opt_state["state"][k], v, tol, k + " momentum")
        if "_conv" in k and k.endswith("_bias"):
            want = mom * mom_before[k] - _np(v)
            got = mom * mom_before[k] - _np(ttr.opt_state["state"][k])
            err = np.abs(got - want).max()
            assert err <= WD_TOL * np.abs(want).max(), (k, "wd update", err)


def _resynced_steps(layout, stem, update=None, steps=3):
    """``steps`` steps of both trainers on one batch, each from
    mxnet_tpu's state; checks the loss and the state after every step."""
    jnet, tnet, _ = _pair(layout, stem)
    x, y = _batch()
    jtr, ttr = _trainers(jnet, tnet, update=update)
    for step in range(steps):
        _load_jax_state(ttr, jtr)
        mom_before = {k: _np(v) for k, v in jtr.opt_state["state"].items()}
        want = float(np.asarray(jtr.step(x, y)))
        got = ttr.step(x, y)
        assert got.dim() == 0 and got.dtype == torch.float32
        assert abs(float(got) - want) <= LOSS_TOL * abs(want), (step, got,
                                                               want)
        _check_state(ttr, jtr, mom_before)
    return jtr, ttr


# ------------------------------------------------------------ functional
@pytest.mark.parametrize("layout,stem", LAYOUTS)
@pytest.mark.parametrize("train", [True, False])
def test_functional_call_matches_jax(layout, stem, train):
    jnet, tnet, values = _pair(layout, stem)
    x, _ = _batch()
    jfn = jpar.functional_call(jnet, train=train)
    jout, jnew = jfn(jpar.param_arrays(jnet), jpar.aux_arrays(jnet),
                     jnp.asarray(x))
    tfn = tpar.functional_call(tnet, train=train)
    params, aux = tpar.param_arrays(tnet), tpar.aux_arrays(tnet)
    before = {k: v.clone() for k, v in aux.items()}
    with torch.no_grad():
        tout, tnew = tfn(params, aux, torch.from_numpy(x))
    _close(tout, jout, STATE_TOL, "outputs")
    assert set(tnew) == set(aux) == set(jnew) - {jpar.functional.RNG_KEY}
    for k in aux:
        _close(tnew[k], jnew[k], STATE_TOL, k)
        # the caller's aux (here: the net's own tensors) is not written
        assert torch.equal(aux[k], before[k]), k
        np.testing.assert_array_equal(tnet.collect_params()[k].numpy(),
                                      values[k])
    moved = any(not torch.equal(tnew[k], before[k]) for k in aux)
    assert moved == train


def test_functional_call_records_a_graph_outside_record():
    _, tnet, _ = _pair("NHWC", "s2d")
    x, _ = _batch()
    params = {k: v.detach().clone().requires_grad_()
              for k, v in tpar.param_arrays(tnet).items()}
    out, _ = tpar.functional_call(tnet, train=True)(
        params, tpar.aux_arrays(tnet), torch.from_numpy(x))
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(p.grad is not None for p in params.values())
    assert not mt.autograd.is_recording() and not mt.autograd.is_training()


# ----------------------------------------------------------------- optim
UPDATE_CASES = [
    ("sgd", {"learning_rate": 0.1, "wd": 1e-2}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-2,
             "rescale_grad": 0.5, "clip_gradient": 0.3}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-2}),
]


@pytest.mark.parametrize("name,opt", UPDATE_CASES,
                         ids=["sgd", "sgd_momentum_clip", "adam"])
def test_make_update_fn_matches_jax(name, opt):
    rng = np.random.RandomState(0)
    shapes = {"w_a": (5, 3), "w_b": (7,), "w_c": (2, 2, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jinit, jupdate = jpar.make_update_fn(name, dict(opt))
    tinit, tupdate = tpar.make_update_fn(name, dict(opt))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jinit(jp), tinit(tp)
    for _ in range(3):
        grads = {k: rng.randn(*s).astype(np.float32)
                 for k, s in shapes.items()}
        jp, js = jupdate(jp, {k: jnp.asarray(g) for k, g in grads.items()},
                         js)
        tp, ts = tupdate(tp, {k: torch.from_numpy(g)
                              for k, g in grads.items()}, ts)
    assert ts["t"] == int(js["t"]) == 3
    for k in shapes:
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        for got, want in zip(jax.tree.leaves(ts["state"][k]),
                             jax.tree.leaves(js["state"][k])):
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("opt", [
    {"learning_rate": 0.1, "wd": 1e-4},
    {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
    {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3,
     "rescale_grad": 0.25, "clip_gradient": 0.5},
], ids=["sgd", "sgd_momentum", "sgd_momentum_clip"])
def test_grouped_sgd_is_bitwise_the_per_parameter_op(opt):
    """The foreach-grouped update and ops.optimizer_ops.sgd_update /
    sgd_mom_update do the same arithmetic, element for element."""
    rng = np.random.RandomState(1)
    shapes = [(64, 3, 3, 8), (8,), (10, 128)]
    ws = [torch.from_numpy(rng.randn(*s).astype(np.float32))
          for s in shapes]
    init, update = tpar.make_update_fn("sgd", dict(opt))
    params = {str(i): w.clone() for i, w in enumerate(ws)}
    state = init(params)
    ref_w = [w.clone() for w in ws]
    ref_m = [torch.zeros_like(w) for w in ws]
    kw = {"lr": opt["learning_rate"], "wd": opt["wd"],
          "rescale_grad": opt.get("rescale_grad", 1.0),
          "clip_gradient": opt.get("clip_gradient")}
    for _ in range(3):
        grads = [torch.from_numpy(rng.randn(*s).astype(np.float32))
                 for s in shapes]
        params, state = update(params, {str(i): g for i, g in
                                        enumerate(grads)}, state)
        for w, g, m in zip(ref_w, grads, ref_m):
            if "momentum" in opt:
                topt.sgd_mom_update(w, g, m, momentum=opt["momentum"], **kw)
            else:
                topt.sgd_update(w, g, **kw)
    for i, w in enumerate(ref_w):
        assert torch.equal(params[str(i)], w), i
        if "momentum" in opt:
            assert torch.equal(state["state"][str(i)], ref_m[i]), i


def test_unregistered_optimizer_raises_listing_the_registry():
    with pytest.raises(ValueError, match=r"'adafactor'.*\['adadelta', "
                       r"'adagrad', 'adam', .*'sgld', 'signum'\]"):
        tpar.make_update_fn("adafactor", {})
    with pytest.raises(ValueError, match="unknown parameters"):
        tpar.make_update_fn("sgd", {"beta1": 0.9})


# ------------------------------------------------------------------ mesh
def test_create_mesh_one_device():
    m = tpar.create_mesh({"dp": 1}, [mt.cpu()])
    assert m.axis_names == ("dp",) and m.shape == {"dp": 1}
    assert list(m.devices.flat) == [torch.device("cpu")]
    m = tpar.create_mesh({"dp": -1, "tp": 1}, [torch.device("cpu")])
    assert m.shape == {"dp": 1, "tp": 1}
    assert tpar.create_mesh(None, [mt.cpu()]).shape == {"dp": 1}


def test_create_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        assert list(tpar.create_mesh().devices.flat) == [
            torch.device("cuda", 0)]
    else:
        with pytest.raises(mt.MXNetError, match="CUDA is not available"):
            tpar.create_mesh()


@pytest.mark.parametrize("axes,n", [({"dp": 2}, 2), ({"dp": 1, "tp": 2}, 2),
                                    (None, 2), ({"dp": 2}, 1)])
def test_create_mesh_over_more_than_one_device_raises(axes, n):
    """A mesh of several ranks needs one process per rank under
    torch.distributed (tests/test_torch_sharded.py runs them); in this
    one process it raises, and sizes that do not match the devices raise
    as mxnet_tpu's do."""
    if n == 1:
        with pytest.raises(ValueError, match="needs 2 devices, got 1"):
            tpar.create_mesh(axes, [mt.cpu()] * n)
        return
    with pytest.raises(mt.MXNetError, match="torch.distributed initialized "
                                            "with world size 2"):
        tpar.create_mesh(axes, [mt.cpu()] * n)


# --------------------------------------------------------------- trainer
@pytest.mark.parametrize("layout,stem", LAYOUTS)
def test_three_sgd_momentum_steps_match_jax(layout, stem):
    jtr, ttr = _resynced_steps(layout, stem)
    assert all(v.dtype == torch.float32 for v in ttr.params.values())
    assert all(v.dtype == torch.float32
               for v in ttr.opt_state["state"].values())
    assert ttr.opt_state["t"] == int(jtr.opt_state["t"]) == 3


def test_wd_left_off_gamma_beta_bias_fails_the_weight_check():
    """Teeth: the gluon optimizer's name rule (no wd on *_gamma, *_beta,
    *_bias) in the trainer's update must fail the check that the
    ShardedTrainer's rule (wd on every parameter) passes."""
    with_wd = tpar.make_update_fn("sgd", dict(OPT))[1]
    without = tpar.make_update_fn("sgd", dict(OPT, wd=0.0))[1]

    def update(params, grads, opt_state):
        plain = [k for k in params if k.endswith(("_gamma", "_beta",
                                                  "_bias"))]
        rest = [k for k in params if k not in plain]
        t = opt_state["t"]
        for names, fn in ((plain, without), (rest, with_wd)):
            sub = {"t": t, "state": {k: opt_state["state"][k]
                                     for k in names}}
            fn({k: params[k] for k in names}, {k: grads[k] for k in names},
               sub)
        opt_state["t"] = t + 1
        return params, opt_state

    with pytest.raises(AssertionError, match="wd update"):
        _resynced_steps("NHWC", "s2d", update=update)


@pytest.mark.parametrize("layout,stem", LAYOUTS)
def test_bfloat16_step_matches_jax(layout, stem):
    """dtype='bfloat16': fp32 masters, momentum and running statistics;
    bf16 forward and backward. The loss within 2e-2 relative, and each
    param and momentum within 3 times mxnet_tpu's own bf16 deviation (its
    bf16 step against its f32 step from the same state) plus 2e-3 of
    scale. Both packages round activations and gradients to bf16 (2^-8) at
    every layer, at other places (the port's BatchNorm applies scale and
    shift in one addcmul), and this narrow net's gradient amplifies that:
    each package's bf16 step lies up to about a tenth of scale from its
    f32 step in the stem conv's weight, and the two bf16 steps lie about
    as far from each other."""
    steps = {}
    for dtype in (None, "bfloat16"):
        jnet, tnet, _ = _pair(layout, stem)
        x, y = _batch()
        jtr, ttr = _trainers(jnet, tnet, dtype=dtype)
        steps[dtype] = (float(np.asarray(jtr.step(x, y))), ttr.step(x, y),
                        jtr, ttr)
    want, got, jtr, ttr = steps["bfloat16"]
    jtr32 = steps[None][2]
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 2e-2 * abs(want), (got, want)
    pairs = [(k, ttr.params[k], v, jtr32.params[k])
             for k, v in jtr.params.items()]
    pairs += [(k + " momentum", ttr.opt_state["state"][k], v,
               jtr32.opt_state["state"][k])
              for k, v in jtr.opt_state["state"].items()]
    for what, mine, ref, ref32 in pairs:
        assert mine.dtype == torch.float32, what
        mine, ref, ref32 = _np(mine), _np(ref), _np(ref32)
        own = np.abs(ref - ref32).max()
        err = np.abs(mine - ref).max()
        assert err <= 3 * own + 2e-3 * max(1.0, np.abs(ref).max()), (
            what, err, own)
    for k, v in _jax_aux(jtr).items():
        assert ttr.aux[k].dtype == torch.float32
        _close(ttr.aux[k], v, 2e-2, k)


@pytest.mark.parametrize("layout,stem", LAYOUTS)
def test_microbatches_two_matches_jax(layout, stem):
    """Two slices of 8 images: each of its BatchNorms normalises what the
    fused three-step test's do."""
    jnet, tnet, _ = _pair(layout, stem)
    x, y = _batch(n=2 * BATCH)
    jtr, ttr = _trainers(jnet, tnet)
    mom_before = {k: _np(v) for k, v in jtr.opt_state["state"].items()}
    want = float(np.asarray(jtr.step(x, y, microbatches=2)))
    got = ttr.step(x, y, microbatches=2)
    assert abs(float(got) - want) <= LOSS_TOL * abs(want), (got, want)
    _check_state(ttr, jtr, mom_before)
    # not the fused step: BatchNorm's statistics are per slice
    fused = tpar.ShardedTrainer(
        tnet, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(OPT),
        mesh=tpar.create_mesh({"dp": 1}, [mt.cpu()]))
    assert abs(float(fused.step(x, y)) - float(got)) > LOSS_TOL * abs(want)
    with pytest.raises(ValueError, match="does not divide the 16-row"):
        ttr.step(x, y, microbatches=3)


@pytest.mark.parametrize("layout,stem", LAYOUTS)
def test_net_unchanged_until_sync_to_net(layout, stem):
    jnet, tnet, values = _pair(layout, stem)
    x, y = _batch()
    jtr, ttr = _trainers(jnet, tnet)
    for _ in range(2):
        _load_jax_state(ttr, jtr)
        jtr.step(x, y)
        ttr.step(torch.from_numpy(x), torch.from_numpy(y))
    for name, t in tnet.collect_params().items():
        np.testing.assert_array_equal(_np(t), values[name], err_msg=name)
    ttr.sync_to_net()
    jtr.sync_to_net()
    jparams = jnet.collect_params()
    for name, t in tnet.collect_params().items():
        assert t.dtype == torch.float32
        _close(t, jparams[name].data().asnumpy(), STATE_TOL, name)
        if name.endswith(("running_mean", "running_var")):
            assert not np.array_equal(_np(t), values[name]), name


def test_step_places_the_batch_and_returns_a_device_scalar():
    _, tnet, _ = _pair("NHWC", "s2d")
    ttr = tpar.ShardedTrainer(
        tnet, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(OPT),
        mesh=tpar.create_mesh({"dp": 1}, [mt.cpu()]))
    x, y = _batch()
    xt = torch.from_numpy(x)
    assert ttr._place(xt) is xt              # already there: no copy
    loss = ttr.step(x, y)                    # numpy is placed
    assert isinstance(loss, torch.Tensor) and loss.dim() == 0
    assert loss.device == torch.device("cpu") and not loss.requires_grad
    ttr.set_learning_rate(0.05)
    assert ttr.learning_rate == 0.05


def test_unported_options_raise():
    _, tnet, _ = _pair("NHWC", "s2d")
    mesh = tpar.create_mesh({"dp": 1}, [mt.cpu()])
    loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    with pytest.raises(NotImplementedError, match="checkpoint_manager"):
        tpar.ShardedTrainer(tnet, loss, "sgd", mesh=mesh,
                            checkpoint_manager=object())
    # tensor parallelism is ported (test_torch_tensor_parallel.py); a spec
    # naming 'tp' on a mesh without that axis is the caller's error
    with pytest.raises(ValueError, match="names 'tp'"):
        tpar.ShardedTrainer(tnet, loss, "sgd", mesh=mesh, param_rules=[
            (".*", tpar.PartitionSpec("tp"))])
    two = np.empty((2,), dtype=object)
    two[:] = [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="holds no process groups"):
        tpar.ShardedTrainer(tnet, loss, "sgd", mesh=tpar.Mesh(two, ["dp"]))
    with pytest.raises(ValueError, match="unsupported sharded optimizer"):
        tpar.ShardedTrainer(tnet, loss, "adafactor", mesh=mesh)
    ttr = tpar.ShardedTrainer(tnet, loss, "sgd", mesh=mesh)
    x, y = _batch()
    with pytest.raises(NotImplementedError, match="length="):
        ttr.step(x, y, length=np.full((BATCH,), 3, np.int32))

"""The port's AMP (op lists, casting policy, LossScaler, the fp16 recipe)
against mxnet_tpu's, on the CPU.

- Every op name of the four lists gets the same dtype from both packages'
  policy, under fp16 and bf16, and the port's op functions that carry
  those names cast their inputs by it, however they are called.
- The LossScaler's scale, skips and counters follow mxnet_tpu's exactly
  over a scripted run of finite and overflowing steps.
- A 2-layer, 64-unit LM's AMP fp16 step (scale_loss, backward, unscale,
  step) matches mxnet_tpu's from the same weights: the loss within 1e-2
  relative and the unscaled gradients within 5e-2 of max|grad| (fp16
  products rounded at other places; both packages' K1 is its plain
  composition here).
- An overflow leaves weights and states bitwise as they were, halves the
  scale and is counted; a captured gluon step with a scaler raises.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.amp import amp as jamp  # noqa: E402
from mxnet_tpu.gluon.model_zoo import transformer as jzoo  # noqa: E402
from mxnet_tpu.resilience import sentinel as jsentinel  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import amp as tamp  # noqa: E402
from mxnet_tpu_torch import capture  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import transformer as tzoo  # noqa: E402
from mxnet_tpu_torch.ops import math as tmath, nn as tnn  # noqa: E402

ALL_OPS = sorted(set(tamp.lists.TARGET_DTYPE_OPS + tamp.lists.FP32_OPS
                     + tamp.lists.FP16_FP32_OPS
                     + tamp.lists.WIDEST_TYPE_CASTS))


@pytest.fixture
def amp_off():
    yield
    tamp.reset()
    mx.amp.reset()


def test_lists_are_mxnet_tpus():
    for name in ("TARGET_DTYPE_OPS", "FP32_OPS", "FP16_FP32_OPS",
                 "WIDEST_TYPE_CASTS"):
        assert getattr(tamp.lists, name) == getattr(mx.amp.lists, name)


@pytest.mark.parametrize("target", ["float16", "bfloat16"])
@pytest.mark.parametrize("op", ALL_OPS)
def test_policy_gives_each_op_the_same_dtype(op, target, amp_off):
    """fp32, fp16 and bf16 inputs (and an int one) through both packages'
    cast_inputs_for: the same dtype for every input."""
    import jax.numpy as jnp

    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    jin = [jnp.asarray(x), jnp.asarray(x, jnp.float16),
           jnp.asarray(x, jnp.bfloat16), jnp.asarray(x, jnp.int32)]
    tin = [torch.from_numpy(x), torch.from_numpy(x).half(),
           torch.from_numpy(x).bfloat16(), torch.from_numpy(x).int()]
    mx.amp.init(target)
    tamp.init(target)
    for pick in ([0], [1], [2], [0, 1], [0, 2], [1, 2, 3], [0, 3]):
        jout = jamp.cast_inputs_for(op, [jin[i] for i in pick])
        tout = tamp.cast_inputs_for(op, [tin[i] for i in pick])
        assert [str(a.dtype) for a in jout] == [
            str(t.dtype).replace("torch.", "") for t in tout], (op, pick)


def _fc():
    x, w, b = torch.randn(2, 4), torch.randn(3, 4), torch.randn(3)
    return tnn.fully_connected(x, w, b)


_OPS = {
    "FullyConnected": lambda: _fc(),
    "Convolution": lambda: tnn.convolution(
        torch.randn(1, 2, 5, 5), torch.randn(3, 2, 3, 3), kernel=(3, 3),
        no_bias=True),
    "LayerNorm": lambda: tnn.layer_norm(torch.randn(2, 4).half(),
                                        torch.ones(4), torch.zeros(4)),
    "softmax": lambda: tnn.softmax(torch.randn(2, 4).half()),
    "log_softmax": lambda: tnn.log_softmax(torch.randn(2, 4).half()),
    "sum": lambda: tmath.sum(torch.randn(2, 4).half(), axis=1),
    "mean": lambda: tmath.mean(torch.randn(2, 4).half()),
    "BatchNorm": lambda: tnn.batch_norm(
        torch.randn(2, 3, 4).half(), torch.ones(3), torch.zeros(3),
        torch.zeros(3), torch.ones(3))[0],
    "CTCLoss": lambda: tnn.ctc_loss(torch.randn(5, 2, 4).half(),
                                    torch.tensor([[1, 2], [1, 0]])),
    "exp": lambda: tmath.exp(torch.randn(3).half()),
    "log": lambda: tmath.log(torch.rand(3).half() + 1),
    "square": lambda: tmath.square(torch.randn(3).half()),
    "norm": lambda: tmath.norm(torch.randn(3).half()),
}


@pytest.mark.parametrize("op", sorted(_OPS))
def test_port_op_functions_apply_the_policy(op, amp_off):
    """Under fp16 AMP the port's op functions compute in the dtype the
    lists give their names (BatchNorm's fp32 only under fp16); off, they
    follow their inputs."""
    want_fp16 = op in tamp.lists.TARGET_DTYPE_OPS
    tamp.init("float16")
    out = _OPS[op]()
    assert out.dtype == (torch.float16 if want_fp16 else torch.float32), op
    tamp.reset()
    out = _OPS[op]()
    # CTC's alphas are float32 for any scores (as mxnet_tpu's)
    off = torch.float32 if want_fp16 or op == "CTCLoss" else torch.float16
    assert out.dtype == off, op


def test_bf16_keeps_batch_norm_in_its_inputs_dtype(amp_off):
    tamp.init("bfloat16")
    x = torch.randn(2, 3, 4).bfloat16()
    out = tnn.batch_norm(x, torch.ones(3), torch.zeros(3), torch.zeros(3),
                         torch.ones(3))[0]
    assert out.dtype == torch.bfloat16
    assert tamp.init_trainer.__module__.endswith("amp")
    assert mt.amp.amp._STATE["loss_scaler"].loss_scale == 1.0


# ----------------------------------------------------------- the scaler
class _Grad:
    """A parameter stand-in whose one gradient both packages read."""

    grad_req = "write"

    def __init__(self, lib, value):
        if lib is mx:
            self._grad = mx.nd.array(value)
        else:
            self._grad = torch.from_numpy(value)

    def list_grad(self):
        return [self._grad]


class _Trainer:
    """What amp.unscale reads of a trainer: its parameters and scaler."""

    def __init__(self, params, scaler):
        self._params, self._amp_loss_scaler = params, scaler


SCRIPT = "ffoffffoofffffffoff"       # f: finite step, o: an overflow


def test_loss_scaler_follows_mxnet_tpu_over_a_scripted_run(amp_off):
    """amp.unscale in both packages over the script: the same answers,
    scales and unskipped counts at every step, the same skip counters."""
    good = np.ones(3, np.float32)
    bad = np.array([1, np.inf, np.nan], np.float32)
    js = mx.amp.LossScaler(init_scale=2. ** 4, scale_window=3)
    ts = tamp.LossScaler(init_scale=2. ** 4, scale_window=3)
    jsentinel.reset_stats()
    tamp.reset_health_stats()
    scales = []
    for c in SCRIPT:
        value = bad if c == "o" else good
        jo = mx.amp.unscale(_Trainer([_Grad(mx, good), _Grad(mx, value)],
                                     js))
        to = tamp.unscale(_Trainer([_Grad(mt, good), _Grad(mt, value)], ts))
        assert jo == to == (c == "f")
        assert ts.loss_scale == js.loss_scale
        assert ts._unskipped == js._unskipped
        scales.append(ts.loss_scale)
    assert min(scales) >= 1.0 and len(set(scales)) > 2
    assert tamp.health_stats() == {
        k: jsentinel.stats()[k] for k in tamp.health_stats()} == {
        "health_skipped_steps": SCRIPT.count("o"),
        "amp_overflow_skips": SCRIPT.count("o")}
    # a noted flag answers once, then the gradients are read again
    ts.note_finite(False)
    assert ts.has_overflow([_Grad(mt, good)]) is True
    assert ts.has_overflow([_Grad(mt, good)]) is False
    ts.note_finite(False)
    ts.clear_note()
    assert ts.has_overflow([_Grad(mt, good)]) is False


# ------------------------------------------------------- the fp16 step
CFG = dict(vocab=64, units=64, num_heads=2, num_layers=2, max_len=32)
T = 16


def _pair(seed=0):
    jnet = jzoo.transformer_lm(impl="flash", prefix="tlm_", **CFG)
    jnet.initialize(mx.init.Xavier())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jnet(mx.nd.array(np.zeros((1, 4)), dtype="int32"))
    rng = np.random.RandomState(seed)
    values = {}
    for name, p in jnet.collect_params().items():
        values[name] = p.data().asnumpy() + (
            rng.randn(*p.shape) * 0.05).astype(np.float32)
        p.set_data(mx.nd.array(values[name]))
    tnet = tzoo.transformer_lm(impl="flash", prefix="tlm_", **CFG)
    tnet.initialize(ctx=mt.cpu())
    tnet.load_numpy_params(values)
    return jnet, tnet


def _batch():
    seq = np.zeros((2, T + 1), np.int64)
    seq[:, 0] = [3, 11]
    for t in range(T):
        seq[:, t + 1] = (5 * seq[:, t] + 3) % CFG["vocab"]
    return seq[:, :-1], seq[:, 1:]


def test_fp16_step_matches_mxnet_tpu(amp_off):
    """One AMP fp16 SGD step of the 2-layer LM in both packages (LAMB's
    own parity is tests/test_torch_optimizers.py's)."""
    jnet, tnet = _pair(seed=3)
    x, y = _batch()
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    mx.amp.init("float16")
    tamp.init("float16")
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    ttr = mt.gluon.Trainer(tnet.collect_params(), "sgd", dict(opt))
    mx.amp.init_trainer(jtr)
    tamp.init_trainer(ttr)
    jloss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with mx.autograd.record():
            jl = jloss_fn(jnet(mx.nd.array(x, dtype="int32")),
                          mx.nd.array(y, dtype="int32")).mean()
            with mx.amp.scale_loss(jl, jtr) as js:
                pass
        js.backward()
    with mt.autograd.record():
        logits = tnet(torch.from_numpy(x))
        tl = tloss_fn(logits, torch.from_numpy(y)).mean()
    with tamp.scale_loss(tl, ttr) as ts:
        ts.backward()
    assert logits.dtype == torch.float16 and tl.dtype == torch.float32
    jloss, tloss = float(jl.asnumpy()), float(tl.detach())
    assert abs(tloss - jloss) <= 1e-2 * abs(jloss), (tloss, jloss)
    scale = ttr._amp_loss_scaler.loss_scale
    assert scale == jtr._amp_loss_scaler.loss_scale == 2. ** 16
    jgrads = {n: p.grad().asnumpy() / scale
              for n, p in jnet.collect_params().items()}
    for n, p in tnet._param_objects().items():
        got = p.grad().numpy() / scale
        want = jgrads[n]
        assert p.grad().dtype == torch.float32
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 5e-2, (n, err)
    assert mx.amp.unscale(jtr) and tamp.unscale(ttr)
    jtr.step(1)
    ttr.step(1)
    for n, p in tnet._param_objects().items():
        want = jnet.collect_params()[n].data().asnumpy()
        got = p.data().detach().numpy()
        assert np.abs(got - want).max() <= 1e-3 * max(np.abs(want).max(),
                                                      1.0), n


def test_overflow_skips_the_step_bitwise(amp_off):
    """An inf in one gradient: unscale says False, the scale halves, the
    skip is counted under mxnet_tpu's names; the caller skips the step, so
    weights and states are bitwise as they were."""
    _, tnet = _pair(seed=4)
    x, y = _batch()
    tamp.init("float16")
    tamp.reset_health_stats()
    tr = mt.gluon.Trainer(tnet.collect_params(), "lamb",
                          {"learning_rate": 1e-3})
    tamp.init_trainer(tr)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()

    def backward():
        with mt.autograd.record():
            loss = loss_fn(tnet(torch.from_numpy(x)),
                           torch.from_numpy(y)).mean()
        with tamp.scale_loss(loss, tr) as s:
            s.backward()

    backward()
    assert tamp.unscale(tr)
    tr.step(1)
    before = {n: t.detach().clone()
              for n, t in tnet.collect_params().items()}
    states = {i: [s.clone() for s in st] for i, st in
              tr._updater.states.items()}
    scale = tr._amp_loss_scaler.loss_scale
    backward()
    next(iter(tnet._param_objects().values())).grad()[0, 0] = float("inf")
    if tamp.unscale(tr):
        tr.step(1)
    assert tr._amp_loss_scaler.loss_scale == scale / 2
    assert tamp.health_stats() == {"health_skipped_steps": 1,
                                   "amp_overflow_skips": 1}
    for n, t in tnet.collect_params().items():
        assert torch.equal(t, before[n]), n
    for i, st in tr._updater.states.items():
        assert all(torch.equal(a, b) for a, b in zip(st, states[i]))
    # mxnet_tpu counts the same skip under the same names
    jsentinel.reset_stats()
    mx.amp.init("float16")
    jtr = mx.gluon.Trainer(_pair(seed=4)[0].collect_params(), "sgd")
    mx.amp.init_trainer(jtr)
    next(iter(jtr._params))._grad[0][:] = float("inf")
    assert not mx.amp.unscale(jtr)
    assert {k: jsentinel.stats()[k] for k in tamp.health_stats()} == {
        "health_skipped_steps": 1, "amp_overflow_skips": 1}


def test_capture_of_an_amp_trainer_raises(amp_off):
    _, tnet = _pair()
    tamp.init("float16")
    tr = mt.gluon.Trainer(tnet.collect_params(), "sgd")
    step = capture.capture(tr, net=tnet, loss_fn=lambda p, y: p.sum())
    tamp.init_trainer(tr)
    with pytest.raises(capture.CaptureError, match="item 4"):
        capture.capture(tr, net=tnet, loss_fn=lambda p, y: p.sum())
    with pytest.raises(capture.CaptureError, match="item 4"):
        step(torch.zeros(1, 4, dtype=torch.int64),
             torch.zeros(1, 4, dtype=torch.int64))


def test_convert_helpers_cast_for_inference(amp_off):
    _, tnet = _pair()
    sym, args, aux = tamp.convert_model(
        "graph", {"w": np.ones(2, np.float32)}, {"m": torch.zeros(2)},
        target_dtype="float16")
    assert sym == "graph" and args["w"].dtype == torch.float16
    assert aux["m"].dtype == torch.float16
    tamp.convert_hybrid_block(tnet, "bfloat16")
    assert all(t.dtype == torch.bfloat16
               for t in tnet.collect_params().values())

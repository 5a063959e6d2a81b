"""K5's requantize, fused into the int8 conv and over the batch's range, in
the PyTorch port against mxnet_tpu, on the CPU.

The batch-range requantize (no calibrated range: the kernel's own range
pass, or a range its producer folded) is held bitwise to mxnet_tpu's
``_requantize`` without bounds, NaN poison on and off; the plain version
of the conv's fused epilogue (``s8_conv_requant_reference``) bitwise to
mxnet_tpu's ``_s8_conv`` -> relu -> ``_requant_epilogue`` chain, and the
executor's chain step (``quantized_conv_requantize``) to its three
registered ops in turn. The executor's plan on ``resnet18_v1`` finds 8
conv -> relu -> calibrated requantize chains and 11 conv -> batch-range
requantize chains, none where an intermediate output has a second reader,
none on the "mma_s8" route; the planned walk is bitwise the unfused one
(every requantize's int8 and range, the logits), and a monitor or a tap
still sees every node. Inputs come from numpy seeds; the kernels
themselves run on the card only (``chip_smoke.py``, and the ``cuda`` test
of ``test_torch_s8_wgmma.py``).
"""
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.ops import quantization as jops  # noqa: E402
from mxnet_tpu.ops import registry as jreg  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
import mxnet_tpu_torch.symbol as tsym  # noqa: E402
from mxnet_tpu_torch.contrib import quantization as tq  # noqa: E402
from mxnet_tpu_torch.gluon import block as tblock  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision  # noqa: E402
from mxnet_tpu_torch.ops import quantization as tops  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402
from mxnet_tpu_torch.symbol.symbol import Symbol  # noqa: E402

F32 = np.float32


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _same_bits(got, want):
    """Bitwise equal as numpy arrays, NaN matching NaN."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_array_equal(got.view(np.uint32)[ok],
                                      want.view(np.uint32)[ok])
    else:
        np.testing.assert_array_equal(got, want)


def _int32(kind, shape=(2, 16, 9, 9), seed=0):
    rng = np.random.RandomState(seed)
    if kind == "full range":
        return rng.randint(-2 ** 31, 2 ** 31 - 1, shape,
                           dtype=np.int64).astype(np.int32)
    x = (rng.randn(*shape) * 3e6).astype(np.int32)
    if kind == "relu'd":
        return np.maximum(x, 0)
    if kind == "zeros":
        return np.zeros(shape, np.int32)
    return x


# -------------------------------------------- the batch-range requantize
@pytest.mark.parametrize("poison", ["1", "0"])
@pytest.mark.parametrize("kind, rin", [
    ("conv-like", 1.7e4), ("relu'd", 1.7e4), ("full range", 37.5),
    ("zeros", 5.0), ("conv-like", float("nan"))],
    ids=["conv-like", "relu'd", "full range", "zeros", "NaN range"])
def test_batch_range_requantize_bitwise_equals_mxnet_tpu(monkeypatch, kind,
                                                         rin, poison):
    """``_requantize`` without a calibrated range (the kernel's mode "own"
    on the card, its plain versions here) and ``requant_epilogue`` handed
    the range as a producer's word (mode "given"), against mxnet_tpu's
    ``_requantize`` without bounds: int8 and both ranges bitwise."""
    monkeypatch.setenv("MXNET_TPU_INT8_NAN_POISON", poison)
    x = _int32(kind)
    lo, hi = F32(-rin), F32(rin)
    want = [np.asarray(w) for w in jops._requantize(
        jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi))]
    got = tops._requantize(_t(x), torch.tensor(lo), torch.tensor(hi))
    real_in = torch.tensor(F32(abs(rin)) if rin == rin else F32(rin))
    word = tops.requant_range_reference(_t(x), real_in)
    given = tops.requant_epilogue(_t(x), real_in, amax=word)
    for g in (got, given):
        if np.isnan(want[2]):       # a NaN range: int8 not defined
            assert all(np.isnan(v.item()) for v in g[1:])
        else:
            for gi, wi in zip(g, want):
                _same_bits(gi.numpy(), wi)
    _same_bits(word.numpy(), want[2])


def test_requant_wrapper_modes_on_the_cpu_count_no_launch():
    x = _t(_int32("relu'd"))
    real_in = torch.tensor(F32(1.7e4))
    before = (tops.requant_epilogue.launches,
              dict(tops.requant_epilogue.launches_by_mode))
    own = tops.requant_epilogue(x, real_in)
    rng = tops.requant_range_reference(x, real_in)
    want = tops.requant_epilogue_reference(x, real_in, -rng, rng)
    assert all(torch.equal(g, w) for g, w in zip(own, want))
    assert (tops.requant_epilogue.launches,
            tops.requant_epilogue.launches_by_mode) == before
    with pytest.raises(ValueError, match="out_min and out_max"):
        tops.requant_epilogue(x, real_in, out_min=-rng)
    with pytest.raises(ValueError, match="out_min and out_max"):
        tops.requant_epilogue(x, real_in, -rng, rng, amax=rng)
    with pytest.raises(ValueError, match="float32 scalar"):
        tops.requant_epilogue(x, real_in, amax=rng.double())


# ------------------------------------------------ the conv's epilogue
def _conv_case(layout, seed=3, n=2, c=24, h=9, cout=40, k=3):
    rng = np.random.RandomState(seed)
    last = layout == "NHWC"
    x = rng.randint(-127, 128, (n, h, h, c) if last else (n, c, h, h))
    w = rng.randint(-127, 128, (cout, k, k, c) if last else (cout, c, k, k))
    bias = rng.randint(-2 ** 16, 2 ** 16, (cout,))
    real_in = F32(2.0 ** 31 * 2.0 / (5376.0 * (c * k * k) ** 0.5))
    return x.astype(np.int8), w.astype(np.int8), bias.astype(np.int32), \
        real_in


def _jax_chain(x, w, bias, stride, pad, layout, relu):
    """mxnet_tpu's ``_s8_conv`` + bias (as its ``_quantized_conv`` adds
    it), then relu."""
    spec = ("NHWC", "OHWI", "NHWC") if layout == "NHWC" else \
        ("NCHW", "OIHW", "NCHW")
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, spec)
    out = jops._s8_conv(jnp.asarray(x), jnp.asarray(w), (stride, stride),
                        [(pad, pad)] * 2, (1, 1), dn, 1)
    b = jnp.asarray(bias)
    out = out + (b if layout == "NHWC" else b.reshape(1, -1, 1, 1))
    return jnp.maximum(out, 0) if relu else out


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("mode", ["requant", "range"])
@pytest.mark.parametrize("stride, pad", [(1, 1), (2, 0)])
def test_conv_requant_reference_equals_mxnet_tpus_chain(layout, relu, mode,
                                                        stride, pad):
    """``s8_conv_requant_reference`` (and the wrapper, which takes it on a
    CPU tensor) against mxnet_tpu's ``_s8_conv`` -> relu ->
    ``_requant_epilogue`` (mode "requant": int8 and range bitwise) or ->
    its batch range (mode "range": int32 exactly, range bitwise)."""
    x, w, bias, real_in = _conv_case(layout)
    chain = _jax_chain(x, w, bias, stride, pad, layout, relu)
    args = (_t(x), _t(w), (stride, stride), (pad, pad), (1, 1), layout,
            _t(bias))
    scal = {"real_in": torch.tensor(real_in), "relu": relu}
    if mode == "requant":
        lo, hi = F32(-3.0), F32(2.5)
        want = jops._requant_epilogue(chain, jnp.asarray(real_in),
                                      jnp.asarray(lo), jnp.asarray(hi))
        scal.update(out_min=torch.tensor(lo), out_max=torch.tensor(hi))
    else:
        fp = chain.astype(jnp.float32) * (jnp.asarray(real_in) /
                                          2147483647.0)
        want = (chain, jnp.max(jnp.abs(fp)))
    for fn in (tops.s8_conv_requant_reference, tops.s8_conv_requant):
        got = fn(*args, **scal)
        assert len(got) == len(want)
        for g, wv in zip(got, want):
            _same_bits(g.numpy(), np.asarray(wv))
    if mode == "requant":   # the values are not all clipped
        q = got[0].numpy()
        assert 0 < (np.abs(q) == 127).mean() < 0.2


def _jax_op(name, arrays, params):
    op = jreg.get_op(name)
    out = op.closed(op.normalize(params))(*[jnp.asarray(a) for a in arrays])
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("calibrated", [True, False])
def test_chain_step_equals_mxnet_tpus_three_ops(relu, calibrated):
    """The executor's chain step ``quantized_conv_requantize`` against
    mxnet_tpu's ``_contrib_quantized_conv`` -> [``_contrib_quantized_act``]
    -> ``_contrib_requantize``: int8 and ranges bitwise."""
    x, w, _, _ = _conv_case("NCHW", seed=5)
    rng = np.random.RandomState(6)
    b = rng.randint(-127, 128, (w.shape[0],)).astype(np.int8)
    ranges = [F32(v) for v in (-1.5, 1.25, -0.02, 0.03, -0.4, 0.5)]
    conv_params = {"kernel": (3, 3), "stride": (1, 1), "pad": (1, 1),
                   "num_filter": w.shape[0]}
    rq_params = {"min_calib_range": -2.0, "max_calib_range": 1.75} \
        if calibrated else {}
    out = _jax_op("_contrib_quantized_conv", [x, w, b, *ranges],
                  conv_params)
    if relu:
        out = _jax_op("_contrib_quantized_act", out, {"act_type": "relu"})
    want = _jax_op("_contrib_requantize", out, rq_params)
    got = tops.quantized_conv_requantize(
        *[_t(a) for a in (x, w, b, *ranges)], **conv_params, relu=relu,
        **rq_params)
    for g, wv in zip(got, want):
        _same_bits(g.numpy(), np.asarray(wv))


# --------------------------------------------------- the executor's plan
@pytest.fixture(scope="module")
def r18():
    """The port's full-int8 ResNet-18 v1 (1000 classes, as served; 32x32
    inputs, so the walk is short), BN folded, naively calibrated."""
    tblock._BlockScope._global_counter.clear()
    tsym.reset_name_counters()
    rng = np.random.RandomState(16)
    net = tvision.resnet18_v1(classes=1000)
    sym = net(tsym.var("data"))
    shapes = dict(zip(sym.list_arguments(),
                      sym.infer_shape(data=(1, 3, 32, 32))[0]))
    args, auxs = {}, {}
    for name in sym.list_arguments():
        if name == "data":
            continue
        shape = shapes[name]
        if name.endswith(("gamma", "running_var")):
            v = rng.rand(*shape) + 0.5
        elif name.endswith(("beta", "running_mean", "bias")):
            v = rng.randn(*shape) * 0.1
        else:
            v = rng.randn(*shape) * (2.0 / np.prod(shape[1:])) ** 0.5
        args[name] = _t(v.astype(np.float32))
    for name, shape in zip(sym.list_auxiliary_states(),
                           sym.infer_shape(data=(1, 3, 32, 32))[2]):
        v = rng.rand(*shape) + 0.5 if name.endswith("var") else \
            rng.randn(*shape) * 0.1
        auxs[name] = _t(v.astype(np.float32))
    folded = tq.fold_batch_norm(sym, args, auxs)
    calib = rng.rand(8, 3, 32, 32).astype(np.float32)
    table = tq.calibrate(*folded, mt.io.NDArrayIter(calib, batch_size=4),
                         calib_mode="naive")
    qsym, qargs, qauxs = tq.quantize_model(*folded, calib_table=table,
                                           quantize_mode="full")
    x = rng.rand(2, 3, 32, 32).astype(np.float32)
    return qsym, qargs, qauxs, x


def _bind(sym, qargs, qauxs, x):
    return sym.bind(mt.cpu(), {**qargs, "data": _t(x)}, aux_states=qauxs)


def test_plan_fuses_8_plus_11_chains_on_resnet18(r18):
    qsym, qargs, qauxs, x = r18
    ex = _bind(qsym, qargs, qauxs, x)
    modes = Counter(c[3] for c in ex.fused_chains)
    assert modes == {"requant": 8, "range": 11}
    for conv, act, rq, mode in ex.fused_chains:
        assert conv.op == "_contrib_quantized_conv"
        assert rq.op == "_contrib_requantize"
        assert (act is not None) == (mode == "requant")
        assert ("min_calib_range" in rq.params) == (mode == "requant")
    # 36 requantize steps: 8 in the conv's epilogue, 28 standalone
    ops = Counter(op.name for _, op, *_ in ex._fused_ops)
    assert ops["_contrib_requantize"] == 36 - 19
    assert ops["_fused_quantized_conv_requantize"] == 19
    assert ops["_contrib_quantized_conv"] == 1


def test_plan_leaves_a_chain_with_a_second_reader(r18):
    """An intermediate output that the graph also returns (a second
    reader) keeps its chain unfused; so does a conv on route "mma_s8"."""
    qsym, qargs, qauxs, x = r18
    ex = _bind(qsym, qargs, qauxs, x)
    conv, act, _, _ = next(c for c in ex.fused_chains
                           if c[3] == "requant")
    conv2, _, _, _ = next(c for c in ex.fused_chains if c[3] == "range")
    for extra, want in (((conv, 0), (7, 11)), ((act, 1), (7, 11)),
                        ((conv2, 2), (8, 10))):
        s = Symbol(list(qsym._outputs) + [extra])
        chains = Counter(c[3] for c in _bind(s, qargs, qauxs,
                                             x).fused_chains)
        assert (chains["requant"], chains["range"]) == want, extra
    saved = tops._s8_route
    tops._s8_route = lambda *a, **kw: "mma_s8"
    try:
        assert _bind(qsym, qargs, qauxs, x).fused_chains == []
    finally:
        tops._s8_route = saved


def test_planned_walk_is_bitwise_the_unfused_one(r18):
    """Every requantize's int8 and range, and the logits, from the fused
    walk and from the unfused one, which a tap selects (the graph returns
    them all, so the chains stay fused: a requantize ends its chain)."""
    qsym, qargs, qauxs, x = r18
    rqs = [n for n in qsym._topo_nodes()
           if not n.is_var and n.op == "_contrib_requantize"]
    s = Symbol(list(qsym._outputs) + [(n, i) for n in rqs
                                       for i in range(3)])
    ex = _bind(s, qargs, qauxs, x)
    assert Counter(c[3] for c in ex.fused_chains) == {"requant": 8,
                                                      "range": 11}
    fused = ex.run(ex.arg_arrays, ex.aux_arrays)[0]
    plain = ex.run(ex.arg_arrays, ex.aux_arrays, tap=lambda *a: None)[0]
    assert len(fused) == 1 + 3 * 36
    for f, p in zip(fused, plain):
        _same_bits(f.numpy(), p.numpy())
    assert torch.isfinite(fused[0]).all() and fused[0].shape == (2, 1000)
    out = _bind(qsym, qargs, qauxs, x).forward()[0]
    assert torch.equal(out, fused[0])


def test_monitor_and_tap_see_every_node(r18):
    qsym, qargs, qauxs, x = r18
    ex = _bind(qsym, qargs, qauxs, x)
    want = Counter()
    for n in qsym._topo_nodes():
        if not n.is_var:
            k = treg.get_op(n.op).num_outputs
            want.update(f"{n.name}_output" if i == 0
                        else f"{n.name}_output{i}" for i in range(k))
    seen = Counter()
    ex.set_monitor_callback(lambda name, t: seen.update([name]))
    out = ex.forward()[0]
    assert seen == want
    tapped = Counter()
    ex.run(ex.arg_arrays, ex.aux_arrays,
           tap=lambda node, i, t: tapped.update([(id(node), i)]))
    assert sum(tapped.values()) == sum(want.values())
    assert torch.equal(out, ex.run(ex.arg_arrays, ex.aux_arrays)[0][0])

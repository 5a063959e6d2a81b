"""INT8 quantization of the PyTorch port against mxnet_tpu, on the CPU.

K5's plain versions (the int8 conv and GEMM in float64, the requantize
step in float32) against ``mxnet_tpu/ops/quantization.py``'s
``_s8_conv`` / ``_s8_matmul`` (int32: exactly equal) and
``_requant_epilogue`` (bitwise, both paths, .5 ties included); every
registered INT8 op against its mxnet_tpu counterpart; BatchNorm folding,
calibration and ``quantize_model(quantize_mode='full')`` on a narrow
ResNet-18 v1 (``thumbnail=True``, 10 classes, 16x16 inputs; built once a
module) against mxnet_tpu's graph JSON, thresholds and int8 weights; then
each quantized node fed mxnet_tpu's recorded inputs, and the whole int8
net against the fp32 graph within mxnet_tpu's own bounds
(``tests/test_int8_e2e.py:74-77``). Inputs come from numpy seeds. The
kernels themselves run on the card only (the ``cuda`` tests).
"""
import json
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.symbol as jsym  # noqa: E402
from mxnet_tpu.contrib import quantization as jq  # noqa: E402
from mxnet_tpu.gluon import block as jblock  # noqa: E402
from mxnet_tpu.gluon.model_zoo import vision as jvision  # noqa: E402
from mxnet_tpu.ops import quantization as jops  # noqa: E402
from mxnet_tpu.ops import registry as jreg  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
import mxnet_tpu_torch.symbol as tsym  # noqa: E402
from mxnet_tpu_torch.contrib import quantization as tq  # noqa: E402
from mxnet_tpu_torch.gluon import block as tblock  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision  # noqa: E402
from mxnet_tpu_torch.ops import quantization as tops  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402

ENTROPY_BINS = 256      # both packages' entropy search, kept short


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _run_jax(sym, args, auxs, x):
    ex = sym.bind(mx.cpu(), {**args, "data": mx.nd.array(x)},
                  aux_states=auxs, grad_req="null")
    return ex.forward(is_train=False)[0].asnumpy()


def _run_port(sym, args, auxs, x):
    ex = sym.bind(mt.cpu(), {**args, "data": _t(x)}, aux_states=auxs)
    return ex.forward()[0].numpy()


@pytest.fixture(scope="module")
def flow():
    """Both packages' ResNet-18 symbols, BN-folded, mxnet_tpu's naive
    table, and both quantized graphs made from that table."""
    jblock._BlockScope._global_counter.clear()
    jsym.symbol._NAME_COUNTERS.clear()
    tblock._BlockScope._global_counter.clear()
    tsym.reset_name_counters()
    rng = np.random.RandomState(2)
    jn = jvision.resnet18_v1(thumbnail=True, classes=10)
    jn.initialize(mx.init.Xavier())
    jn(mx.nd.array(rng.rand(1, 3, 16, 16).astype(np.float32)))
    js = jn(jsym.var("data"))
    params = {}
    for k, p in jn.collect_params().items():
        v = p.data().asnumpy()
        if k.endswith(("running_mean", "beta")):
            v = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith(("running_var", "gamma")):
            v = (rng.rand(*v.shape) + 0.5).astype(np.float32)
        params[k] = v
    ts = tvision.resnet18_v1(thumbnail=True, classes=10)(tsym.var("data"))
    jargs = {k: mx.nd.array(v) for k, v in params.items()
             if k in js.list_arguments()}
    jauxs = {k: mx.nd.array(v) for k, v in params.items()
             if k in js.list_auxiliary_states()}
    targs = {k: _t(v) for k, v in params.items() if k in ts.list_arguments()}
    tauxs = {k: _t(v) for k, v in params.items()
             if k in ts.list_auxiliary_states()}
    jf = jq.fold_batch_norm(js, jargs, jauxs)
    tf = tq.fold_batch_norm(ts, targs, tauxs)
    calib = rng.rand(8, 3, 16, 16).astype(np.float32)
    jtable = jq.calibrate(*jf, mx.io.NDArrayIter(calib, batch_size=4),
                          calib_mode="naive")
    ttable = tq.CalibrationTable.from_json(jtable.to_json())
    jqf = jq.quantize_model(*jf, calib_table=jtable, quantize_mode="full")
    tqf = tq.quantize_model(*tf, calib_table=ttable, quantize_mode="full")
    x = rng.rand(8, 3, 16, 16).astype(np.float32)
    return {"js": js, "ts": ts, "jf": jf, "tf": tf, "calib": calib,
            "jtable": jtable, "ttable": ttable, "jq": jqf, "tq": tqf,
            "x": x, "params": params}


def _split_np(sym, params):
    return ({k: _t(v) for k, v in params.items()
             if k in sym.list_arguments()},
            {k: _t(v) for k, v in params.items()
             if k in sym.list_auxiliary_states()})


# ------------------------------------------------------------ K5 plain
CONV_CASES = [
    # (N, Cin, H, W, Cout, k, stride, pad, dilate, groups)
    (2, 8, 9, 9, 16, 3, 1, 1, 1, 1),
    (2, 8, 10, 11, 16, 3, 2, 1, 1, 1),
    (1, 3, 23, 23, 16, 7, 2, 3, 1, 1),          # the stem: K = 147
    (2, 16, 8, 8, 32, 1, 2, 0, 1, 1),           # a 1x1 downsample
    (2, 5, 12, 9, 8, 3, 1, 0, 2, 1),            # dilation 2, K = 45
    (2, 8, 9, 9, 16, 3, 1, 1, 1, 2),            # two groups
    (1, 64, 7, 7, 64, 3, 1, 1, 1, 1),           # K = 576
    (3, 4, 6, 5, 12, 2, 2, 1, 2, 2),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_s8_conv_reference_equals_mxnet_tpu_exactly(case):
    n, cin, h, w, cout, k, s, p, d, g = case
    rng = np.random.RandomState(sum(case))
    x = rng.randint(-127, 128, (n, cin, h, w)).astype(np.int8)
    wt = rng.randint(-127, 128, (cout, cin // g, k, k)).astype(np.int8)
    dn = jax.lax.conv_dimension_numbers(x.shape, wt.shape,
                                        ("NCHW", "OIHW", "NCHW"))
    want = np.asarray(jops._s8_conv(jnp.asarray(x), jnp.asarray(wt), (s, s),
                                    [(p, p)] * 2, (d, d), dn, g))
    got = tops.s8_conv_reference(_t(x), _t(wt), (s, s), (p, p), (d, d), g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the CPU wrapper takes the plain version and counts no launch
    before = tops.s8_conv.launches
    np.testing.assert_array_equal(
        tops.s8_conv(_t(x), _t(wt), (s, s), (p, p), (d, d), g).numpy(),
        want)
    assert tops.s8_conv.launches == before


def test_s8_conv_reference_channels_last_equals_mxnet_tpu():
    rng = np.random.RandomState(4)
    x = rng.randint(-127, 128, (2, 9, 9, 8)).astype(np.int8)
    wt = rng.randint(-127, 128, (16, 3, 3, 8)).astype(np.int8)
    dn = jax.lax.conv_dimension_numbers(x.shape, wt.shape,
                                        ("NHWC", "OHWI", "NHWC"))
    want = np.asarray(jops._s8_conv(jnp.asarray(x), jnp.asarray(wt), (2, 2),
                                    [(1, 1)] * 2, (1, 1), dn, 1))
    got = tops.s8_conv_reference(_t(x), _t(wt), (2, 2), (1, 1), (1, 1),
                                 layout="NHWC")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m, k, n", [(8, 512, 1000), (5, 45, 7),
                                     (33, 4608, 70)])
def test_s8_matmul_reference_equals_mxnet_tpu_exactly(m, k, n):
    rng = np.random.RandomState(m + k + n)
    x = rng.randint(-127, 128, (m, k)).astype(np.int8)
    wt = rng.randint(-127, 128, (n, k)).astype(np.int8)
    want = np.asarray(jops._s8_matmul(jnp.asarray(x), jnp.asarray(wt)))
    got = tops.s8_matmul_reference(_t(x), _t(wt))
    np.testing.assert_array_equal(got.numpy(), want)
    bias = rng.randint(-2 ** 20, 2 ** 20, (n,)).astype(np.int32)
    np.testing.assert_array_equal(
        tops.s8_matmul(_t(x), _t(wt), bias=_t(bias)).numpy(), want + bias)


def _requant_inputs(kind):
    rng = np.random.RandomState(len(kind))
    if kind == "ties":
        # real_in 2^31: x * 127 / 254 = x / 2, every odd x a .5 tie
        return (np.arange(-4001, 4002, dtype=np.int32), 2.0 ** 31, -254.0,
                254.0)
    if kind == "full range":
        return (rng.randint(-2 ** 31, 2 ** 31 - 1, 50000, dtype=np.int64)
                .astype(np.int32), 37.5, -3.25, 2.0)
    return ((rng.randn(4, 16, 7, 7) * 3e6).astype(np.int32), 1.7e4, -9.0,
            11.5)


@pytest.mark.parametrize("path", ["via_fp32", "fused_scale"])
@pytest.mark.parametrize("kind", ["ties", "full range", "conv-like"])
def test_requant_epilogue_reference_bitwise_equals_mxnet_tpu(path, kind):
    x, rin, lo, hi = _requant_inputs(kind)
    f = np.float32
    want = jops._requant_epilogue(jnp.asarray(x), jnp.asarray(f(rin)),
                                  jnp.asarray(f(lo)), jnp.asarray(f(hi)),
                                  path=path)
    got = tops.requant_epilogue_reference(
        _t(x), torch.tensor(f(rin)), torch.tensor(f(lo)),
        torch.tensor(f(hi)), path=path)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert g.item() == float(w)
    if kind == "ties":   # the ties round half to even, as jnp.round does
        assert got[0][4001 + 1].item() == 0 and \
            got[0][4001 + 3].item() == 2


def test_requant_wrapper_takes_the_plain_version_on_cpu():
    x, rin, lo, hi = _requant_inputs("conv-like")
    args = [torch.tensor(np.float32(v)) for v in (rin, lo, hi)]
    before = tops.requant_epilogue.launches
    got = tops.requant_epilogue(_t(x), *args)
    want = tops.requant_epilogue_reference(_t(x), *args)
    assert torch.equal(got[0], want[0])
    assert tops.requant_epilogue.launches == before
    with pytest.raises(ValueError, match="path"):
        tops.requant_epilogue(_t(x), *args, path="int4")


def test_nan_range_propagates_through_the_epilogue():
    x = _t(np.arange(10, dtype=np.int32))
    _, lo, hi = tops.requant_epilogue_reference(
        x, torch.tensor(3.0), torch.tensor(-1.0), torch.tensor(float("nan")))
    assert torch.isnan(lo) and torch.isnan(hi)


# --------------------------------------------------------- the INT8 ops
def _jax_op(name, arrays, params):
    op = jreg.get_op(name)
    out = op.closed(op.normalize(params))(*[jnp.asarray(a) for a in arrays])
    return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                    else (out,))]


def _port_op(name, arrays, params):
    op = treg.get_op(name)
    out = op.closed(op.normalize(params))(*[_t(a) for a in arrays])
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def _f(v):
    return np.float32(v)


def _op_cases():
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 8, 6, 6) * 2).astype(np.float32)
    i8 = rng.randint(-127, 128, (2, 8, 6, 6)).astype(np.int8)
    i32 = (rng.randn(2, 8, 6, 6) * 3e8).astype(np.int32)
    u8 = rng.randint(0, 256, (2, 8, 6, 6)).astype(np.uint8)
    rq = (_f(-3.0), _f(2.5))
    return [
        ("quantize int8", "_contrib_quantize", [x, *rq], {}),
        ("quantize uint8", "_contrib_quantize", [x, *rq],
         {"out_type": "uint8"}),
        ("quantize_v2 calibrated", "_contrib_quantize_v2", [x],
         {"min_calib_range": -3.0, "max_calib_range": 2.5}),
        ("quantize_v2 auto uint8", "_contrib_quantize_v2", [np.abs(x)],
         {"min_calib_range": 0.0, "max_calib_range": 2.5,
          "out_type": "auto"}),
        ("quantize_v2 runtime range", "_contrib_quantize_v2", [x], {}),
        ("dequantize int8", "_contrib_dequantize", [i8, *rq], {}),
        ("dequantize int32", "_contrib_dequantize", [i32, *rq], {}),
        ("dequantize uint8", "_contrib_dequantize", [u8, *rq], {}),
        ("requantize calibrated", "_contrib_requantize", [i32, *rq],
         {"min_calib_range": -1.5, "max_calib_range": 1.0}),
        ("requantize runtime range", "_contrib_requantize", [i32, *rq], {}),
        ("pooling max 3x3 s2 p1", "_contrib_quantized_pooling",
         [i8, *rq], {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                     "pool_type": "max"}),
        ("pooling max int32 full", "_contrib_quantized_pooling",
         [i32, *rq], {"kernel": (2, 2), "stride": (2, 2), "pool_type": "max",
                      "pooling_convention": "full"}),
        ("pooling avg global int32", "_contrib_quantized_pooling",
         [i32, *rq], {"kernel": (1, 1), "global_pool": True,
                      "pool_type": "avg", "pooling_convention": "full"}),
        ("pooling avg 3x3 no pad count", "_contrib_quantized_pooling",
         [i8, *rq], {"kernel": (3, 3), "stride": (1, 1), "pad": (1, 1),
                     "pool_type": "avg", "count_include_pad": False}),
        ("act relu int32", "_contrib_quantized_act", [i32, *rq],
         {"act_type": "relu"}),
        ("flatten", "_contrib_quantized_flatten", [i8, *rq], {}),
        ("elemwise_add", "_contrib_quantized_elemwise_add",
         [i8, i8[::-1].copy(), *rq, _f(-1.0), _f(0.75)], {}),
        ("elemwise_mul", "_contrib_quantized_elemwise_mul",
         [i8, i8[::-1].copy(), *rq, _f(-1.0), _f(0.75)], {}),
        ("concat", "_contrib_quantized_concat",
         [i8, i8[:, :4].copy(), *rq, _f(-1.0), _f(0.75)],
         {"num_args": 2, "dim": 1}),
        ("batch_norm", "_contrib_quantized_batch_norm",
         [i8, *(rng.rand(4, 8).astype(np.float32) + 0.5), *rq],
         {"min_calib_range": -2.0, "max_calib_range": 2.0, "eps": 1e-3}),
        ("embedding", "_contrib_quantized_embedding",
         [np.array([[0, 3], [5, 1]], np.float32),
          rng.randint(-127, 128, (6, 4)).astype(np.int8), *rq], {}),
        ("fully_connected", "_contrib_quantized_fully_connected",
         [i8, rng.randint(-127, 128, (5, 288)).astype(np.int8),
          rng.randint(-127, 128, (5,)).astype(np.int8), *rq, _f(-0.5),
          _f(0.5), _f(-0.25), _f(0.2)], {"num_hidden": 5}),
        ("conv", "_contrib_quantized_conv",
         [i8, rng.randint(-127, 128, (4, 8, 3, 3)).astype(np.int8),
          rng.randint(-127, 128, (4,)).astype(np.int8), *rq, _f(-0.5),
          _f(0.5), _f(-0.25), _f(0.2)],
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
          "num_filter": 4}),
    ]


@pytest.mark.parametrize("case", _op_cases(), ids=lambda c: c[0])
def test_int8_op_matches_mxnet_tpu(case):
    """Integer outputs exactly equal; float outputs (ranges, dequantized
    values) equal to float32 rounding."""
    _, name, arrays, params = case
    want = _jax_op(name, arrays, params)
    got = _port_op(name, arrays, params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-7, atol=0)


def test_quantize_v2_poison_and_knob(monkeypatch):
    x = np.ones((2, 3), np.float32)
    x[0, 1] = np.nan
    params = {"min_calib_range": -1.0, "max_calib_range": 1.0}
    _, lo, hi = _port_op("_contrib_quantize_v2", [x], params)
    assert np.isnan(lo) and np.isnan(hi)
    monkeypatch.setenv("MXNET_TPU_INT8_NAN_POISON", "0")
    _, lo, hi = _port_op("_contrib_quantize_v2", [x], params)
    assert lo == -1.0 and hi == 1.0


# ----------------------------------------------------- graph rewriting
def test_fold_batch_norm_matches_mxnet_tpu(flow):
    (jsy, ja, jx), (tsy, ta, tx) = flow["jf"], flow["tf"]
    assert json.loads(tsy.tojson()) == json.loads(jsy.tojson())
    assert sorted(ta) == sorted(ja) and sorted(tx) == sorted(jx) == []
    for k in ja:
        w = ja[k].asnumpy()
        np.testing.assert_allclose(ta[k].numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max())
    assert "BatchNorm" not in {n.op for n in tsy._topo_nodes()}


def test_folded_graph_runs_like_the_unfolded_one(flow):
    x = flow["x"]
    got = _run_port(*flow["tf"], x)
    want = _run_jax(*flow["jf"], x)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    unfolded = _run_port(flow["ts"], *_split_np(flow["ts"], flow["params"]),
                         x)
    np.testing.assert_allclose(got, unfolded, rtol=0,
                               atol=1e-4 * np.abs(unfolded).max())


def test_fold_batch_norm_keys_a_shared_weight_per_conv():
    """One weight read by two convs, each with its own BatchNorm: each
    fold gets its own parameters (the second keyed on its conv node's
    name, where mxnet_tpu's ``fold_batch_norm`` overwrites the first), so
    the folded graph computes what the unfolded one does."""
    rng = np.random.RandomState(7)
    data, w = tsym.var("data"), tsym.var("shared_weight")
    branches = []
    for i in range(2):
        c = tsym.Convolution(data, weight=w, kernel=(3, 3), pad=(1, 1),
                             num_filter=4, no_bias=True, name=f"conv{i}")
        branches.append(tsym.BatchNorm(c, fix_gamma=False, name=f"bn{i}"))
    sy = tsym.elemwise_add(*branches, name="sum")
    args = {"shared_weight": _t(rng.randn(4, 3, 3, 3).astype(np.float32))}
    auxs = {}
    for i in range(2):
        args[f"bn{i}_gamma"] = _t(rng.rand(4).astype(np.float32) + 0.5)
        args[f"bn{i}_beta"] = _t(rng.randn(4).astype(np.float32))
        auxs[f"bn{i}_moving_mean"] = _t(rng.randn(4).astype(np.float32))
        auxs[f"bn{i}_moving_var"] = _t(rng.rand(4).astype(np.float32) + .5)
    fs, fa, fx = tq.fold_batch_norm(sy, args, auxs)
    assert sorted(fa) == ["conv1_bnfold", "conv1_bnfold_bias",
                          "shared_weight_bnfold",
                          "shared_weight_bnfold_bias"]
    x = rng.rand(2, 3, 6, 6).astype(np.float32)
    want = _run_port(sy, args, auxs, x)
    got = _run_port(fs, fa, fx, x)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _pool_net(pool_type):
    data = tsym.var("data")
    c = tsym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=8,
                         name="pc1")
    r = tsym.Activation(c, act_type="relu", name="pr1")
    p = tsym.Pooling(r, kernel=(2, 2), stride=(2, 2), pool_type=pool_type,
                     name="pp1")
    return tsym.FullyConnected(p, num_hidden=10, name="pfc1")


@pytest.mark.parametrize("pool_type", ["sum", "max", "avg"])
def test_int8_rewrite_quantizes_max_and_avg_pools_only(pool_type):
    """The full-int8 rewrite turns a max or avg Pooling into
    ``_contrib_quantized_pooling``; a 'sum' pool, which the quantized op
    does not take, stays fp32 behind its dequantize, and the graph runs
    (``mxnet_tpu`` rewrites it too, and then raises)."""
    rng = np.random.RandomState(9)
    sy = _pool_net(pool_type)
    args = {"pc1_weight": rng.randn(8, 3, 3, 3) * 0.2,
            "pc1_bias": rng.randn(8) * 0.05,
            "pfc1_weight": rng.randn(10, 8 * 4 * 4) * 0.1,
            "pfc1_bias": np.zeros(10)}
    args = {k: _t(v.astype(np.float32)) for k, v in args.items()}
    calib = rng.rand(8, 3, 8, 8).astype(np.float32)
    table = tq.calibrate(sy, args, {}, mt.io.NDArrayIter(calib,
                                                         batch_size=4),
                         calib_mode="naive")
    qs, qa, qx = tq.quantize_model(sy, args, {}, calib_table=table,
                                   quantize_mode="full")
    ops = Counter(n.op for n in qs._topo_nodes() if not n.is_var)
    quantized = pool_type != "sum"
    assert ops["_contrib_quantized_pooling"] == int(quantized)
    assert ops["Pooling"] == int(not quantized)
    x = rng.rand(4, 3, 8, 8).astype(np.float32)
    got = _run_port(qs, qa, qx, x)
    want = _run_port(sy, args, {}, x)
    assert got.shape == (4, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.1 * np.abs(want).max())


def test_quantize_model_full_matches_mxnet_tpu(flow):
    (jqs, jqa, _), (tqs, tqa, _) = flow["jq"], flow["tq"]
    assert json.loads(tqs.tojson()) == json.loads(jqs.tojson())
    ops = Counter(n.op for n in tqs._topo_nodes() if not n.is_var)
    assert ops == Counter(n.op for n in jqs._topo_nodes() if not n.is_var)
    assert ops["_contrib_quantized_conv"] == 20 and \
        ops["_contrib_requantize"] == 36 and \
        ops["_contrib_quantize_v2"] == 1 and ops["_contrib_dequantize"] == 1
    assert sorted(tqa) == sorted(jqa)
    total = off = 0
    for k, v in jqa.items():
        w, g = v.asnumpy(), tqa[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        if w.dtype == np.int8:
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1
            total, off = total + d.size, off + int((d > 0).sum())
        else:
            np.testing.assert_array_equal(g, w)
    assert off <= 1e-3 * total


def test_symbol_digest_and_table_json_match(flow):
    jt, tt = flow["jtable"], flow["ttable"]
    assert tq.symbol_digest(flow["tf"][0]) == jq.symbol_digest(
        flow["jf"][0]) == jt.model_digest
    assert tt.to_json() == jt.to_json() and tt.digest() == jt.digest()
    tt.validate_for(flow["tf"][0], arg_params=flow["tf"][1])


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_calibration_tables_match_mxnet_tpu(flow, mode):
    """The port's calibration of the folded graph against mxnet_tpu's on
    the same batches: the same keys and digest, thresholds within 1e-5
    relative."""
    calib = flow["calib"]
    kw = {"num_bins": ENTROPY_BINS} if mode == "entropy" else {}
    jt = jq.calibrate(*flow["jf"], mx.io.NDArrayIter(calib, batch_size=4),
                      calib_mode=mode, **kw)
    tt = tq.calibrate(*flow["tf"], mt.io.NDArrayIter(calib, batch_size=4),
                      calib_mode=mode, **kw)
    assert sorted(tt.thresholds) == sorted(jt.thresholds)
    assert tt.model_digest == jt.model_digest
    assert tt.num_examples == jt.num_examples == 8
    for k, (lo, hi) in jt.thresholds.items():
        np.testing.assert_allclose(tt.thresholds[k], (lo, hi), rtol=1e-5,
                                   atol=0)


def test_entropy_threshold_matches_mxnet_tpu():
    rng = np.random.RandomState(9)
    hist = np.histogram(np.abs(rng.standard_t(3, 20000)), bins=512,
                        range=(0, 12))[0]
    edges = np.linspace(0, 12, 513)
    assert tq._entropy_threshold(hist, edges) == \
        jq._entropy_threshold(hist, edges)


def test_device_histogram_bins_like_jnp_histogram():
    rng = np.random.RandomState(10)
    a = (rng.randn(5000) * 3).astype(np.float32)
    hi = float(np.abs(a).max())
    a[:3] = [hi, -hi, 0.0]
    want = np.asarray(jnp.histogram(jnp.abs(jnp.asarray(a)), bins=64,
                                    range=(0.0, hi))[0]).astype(np.int64)
    np.testing.assert_array_equal(tq._device_abs_hist(_t(a), hi, 64), want)


# ---------------------------------------------------- the int8 network
def test_each_quantized_node_matches_mxnet_tpu(flow):
    """Walk mxnet_tpu's int8 graph, and feed every node's recorded inputs
    to the port's op of the same name and parameters: int32 outputs
    exactly equal, int8 within one level on <= 0.5 % of elements, ranges
    and floats to float32 rounding. The images are 56x56, so the global
    average pool is 7x7 as at 224x224: XLA on the CPU sums such a window
    in row-major order, as the port does (its 2x2, 4x4 and 8x8 windows
    take other orders, a few float32 ulps apart on the int32 grid)."""
    jqs, jqa, jqx = flow["jq"]
    x = np.random.RandomState(12).rand(2, 3, 56, 56).astype(np.float32)
    feeds = {**{k: v.asnumpy() for k, v in jqa.items()}, "data": x}
    env = {}
    checked = Counter()
    for node in jqs._topo_nodes():
        if node.is_var:
            env[(id(node), 0)] = feeds[node.name]
            continue
        ins = [env[(id(i), s)] for i, s in node.inputs]
        want = _jax_op(node.op, ins, node.params)
        got = _port_op(node.op, ins, node.params)
        for i, (g, w) in enumerate(zip(got, want)):
            env[(id(node), i)] = w
            assert g.dtype == w.dtype and g.shape == w.shape, node.name
            if w.dtype == np.int32:
                np.testing.assert_array_equal(g, w, err_msg=node.name)
            elif w.dtype == np.int8:
                d = np.abs(g.astype(np.int32) - w.astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() <= 5e-3, node.name
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6,
                                           atol=1e-6 * np.abs(w).max(),
                                           err_msg=node.name)
        checked[node.op] += 1
    assert checked["_contrib_quantized_conv"] == 20
    assert checked["_contrib_requantize"] == 36


def test_int8_net_within_mxnet_tpus_bounds(flow):
    x = flow["x"]
    fp32 = _run_port(*flow["tf"], x)
    got = _run_port(*flow["tq"], x)
    scale = np.abs(fp32).max()
    assert np.abs(got - fp32).max() < 0.15 * scale
    assert (fp32.argmax(axis=1) == got.argmax(axis=1)).mean() >= 0.75
    want = _run_jax(*flow["jq"], x)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * scale)


def test_quantize_model_errors_match_mxnet_tpu(flow):
    sy, a, x = flow["tf"]
    with pytest.raises(mt.MXNetError, match="not both"):
        tq.quantize_model(sy, a, x, calib_table=flow["ttable"],
                          calib_data=mt.io.NDArrayIter(flow["calib"],
                                                    batch_size=4),
                          quantize_mode="full")
    with pytest.raises(mt.MXNetError, match="requires calibration"):
        tq.quantize_model(sy, a, x, quantize_mode="full")
    with pytest.raises(mt.MXNetError, match="int8 or uint8"):
        tq.quantize_model(sy, a, x, quantized_dtype="int4")
    stale = tq.CalibrationTable(flow["ttable"].thresholds, "naive",
                                model_digest="0" * 16)
    with pytest.raises(tq.CalibrationMismatchError) as ei:
        tq.quantize_model(sy, a, x, calib_table=stale, quantize_mode="full")
    assert ei.value.model_digest == "0" * 16


def test_fake_mode_matches_mxnet_tpu(flow):
    jsy = jq.quantize_model(*flow["jf"], calib_table=flow["jtable"])[0]
    tsy = tq.quantize_model(*flow["tf"], calib_table=flow["ttable"])[0]
    assert json.loads(tsy.tojson()) == json.loads(jsy.tojson())
    got = _run_port(tsy, flow["tf"][1], {}, flow["x"])
    want = _run_jax(jsy, flow["jf"][1], {}, flow["x"])
    # float32 rounding upstream flips single int8 levels (1/127 of a
    # boundary's range each), and flips add up over the 20 boundaries
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-2 * np.abs(want).max())
    assert (got.argmax(axis=1) == want.argmax(axis=1)).mean() >= 0.75


# ------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES[:5] + CONV_CASES[6:7], ids=str)
def test_s8_conv_kernel_equals_its_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    n, cin, h, w, cout, k, s, p, d, _ = case
    gen = torch.Generator(device="cuda").manual_seed(sum(case))
    x = torch.randint(-127, 128, (n, cin, h, w), generator=gen,
                      device="cuda", dtype=torch.int8)
    wt = torch.randint(-127, 128, (cout, cin, k, k), generator=gen,
                       device="cuda", dtype=torch.int8)
    got = tops.s8_conv(x, wt, (s, s), (p, p), (d, d))
    with torch.backends.cudnn.flags(enabled=False):
        want = tops.s8_conv_reference(x, wt, (s, s), (p, p), (d, d))
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_k5_kernels_on_the_card_raise_and_match():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    x = torch.randint(-127, 128, (2, 8, 9, 9), device="cuda",
                      dtype=torch.int8)
    with pytest.raises(mt.MXNetError, match="ROADMAP"):
        tops.s8_conv(x, torch.ones((8, 4, 3, 3), dtype=torch.int8,
                                   device="cuda"), 1, 1, 1, num_group=2)
    a = torch.randint(-127, 128, (33, 80), device="cuda", dtype=torch.int8)
    b = torch.randint(-127, 128, (70, 80), device="cuda", dtype=torch.int8)
    assert torch.equal(tops.s8_matmul(a, b), tops.s8_matmul_reference(a, b))
    d = torch.randint(-2 ** 30, 2 ** 30, (1001,), device="cuda",
                      dtype=torch.int32)
    r = [torch.tensor(v, device="cuda") for v in (9e3, -2.0, 3.0)]
    for path in ("via_fp32", "fused_scale"):
        got = tops.requant_epilogue(d, *r, path=path)
        want = tops.requant_epilogue_reference(d, *r, path=path)
        assert all(torch.equal(g, w) for g, w in zip(got, want))

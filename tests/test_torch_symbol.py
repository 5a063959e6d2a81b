"""The Symbol layer of the PyTorch port against mxnet_tpu, on the CPU.

ResNet-18 v1 is traced symbolically in both packages (name counters reset
on both sides): the graph JSON, argument / auxiliary lists, inferred
shapes and monitor names are equal exactly; a graph exported by either
package loads in the other and exports back unchanged; ``.params`` files
cross both ways bit for bit; the fp32 executor forward agrees within 1e-4
of max|mxnet_tpu|. Inputs come from a numpy seed; the narrow net
(``thumbnail=True``, 10 classes, 16x16 inputs) is built once a module.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.symbol as jsym  # noqa: E402
from mxnet_tpu.gluon import block as jblock  # noqa: E402
from mxnet_tpu.gluon.model_zoo import vision as jvision  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
import mxnet_tpu_torch.symbol as tsym  # noqa: E402
from mxnet_tpu_torch import ndarray as tnd  # noqa: E402
from mxnet_tpu_torch.gluon import block as tblock  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")


def _fresh_names():
    jblock._BlockScope._global_counter.clear()
    jsym.symbol._NAME_COUNTERS.clear()
    tblock._BlockScope._global_counter.clear()
    tsym.reset_name_counters()


def _perturbed(params, rng):
    """BatchNorm statistics and scales away from their init, so a wrong
    binding or a skipped BatchNorm shows."""
    out = {}
    for k, v in params.items():
        if k.endswith(("running_mean", "beta")):
            v = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith(("running_var", "gamma")):
            v = (rng.rand(*v.shape) + 0.5).astype(np.float32)
        out[k] = v
    return out


@pytest.fixture(scope="module")
def nets():
    """(mxnet_tpu net, its symbol, port net, its symbol, numpy params)."""
    _fresh_names()
    rng = np.random.RandomState(3)
    jn = jvision.resnet18_v1(thumbnail=True, classes=10)
    jn.initialize(mx.init.Xavier())
    jn(mx.nd.array(rng.rand(1, 3, 16, 16).astype(np.float32)))
    js = jn(jsym.var("data"))
    params = _perturbed({k: p.data().asnumpy()
                         for k, p in jn.collect_params().items()}, rng)
    for k, v in params.items():
        jn.collect_params()[k].set_data(mx.nd.array(v))
    tn = tvision.resnet18_v1(thumbnail=True, classes=10)
    tn.initialize(ctx=mt.cpu())
    tn.load_numpy_params(params)
    ts = tn(tsym.var("data"))
    return jn, js, tn, ts, params


def _split(sym, params, to):
    args = {k: to(v) for k, v in params.items()
            if k in sym.list_arguments()}
    auxs = {k: to(v) for k, v in params.items()
            if k in sym.list_auxiliary_states()}
    return args, auxs


def _jax_forward(sym, params, x, tap=None):
    args, auxs = _split(sym, params, mx.nd.array)
    ex = sym.bind(mx.cpu(), {**args, "data": mx.nd.array(x)},
                  aux_states=auxs, grad_req="null")
    if tap is not None:
        ex.set_monitor_callback(tap, monitor_all=True)
    return ex.forward(is_train=False)[0].asnumpy()


def _torch_forward(sym, params, x, tap=None):
    args, auxs = _split(sym, params, torch.from_numpy)
    ex = sym.bind(mt.cpu(), {**args, "data": torch.from_numpy(x)},
                  aux_states=auxs)
    if tap is not None:
        ex.set_monitor_callback(tap, monitor_all=True)
    return ex.forward()[0].numpy()


# ------------------------------------------------------------- the graph
@pytest.mark.parametrize("thumbnail", [True, False])
def test_traced_resnet18_json_equals_mxnet_tpu(thumbnail):
    _fresh_names()
    js = jvision.resnet18_v1(thumbnail=thumbnail, classes=10)(
        jsym.var("data"))
    ts = tvision.resnet18_v1(thumbnail=thumbnail, classes=10)(
        tsym.var("data"))
    assert json.loads(ts.tojson()) == json.loads(js.tojson())
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.list_outputs() == js.list_outputs()
    names = [n.name for n in ts._topo_nodes() if not n.is_var]
    assert "fwd" in names and "elemwiseadd0" in names \
        and "activation0" in names and "fullyconnected0" in names


def test_infer_shape_equals_mxnet_tpu(nets):
    _, js, _, ts, _ = nets
    got = ts.infer_shape(data=(2, 3, 16, 16))
    want = js.infer_shape(data=(2, 3, 16, 16))
    assert [[tuple(s) for s in part] for part in got] == \
        [[tuple(s) for s in part] for part in want]
    internals = ts.get_internals()
    assert internals.list_outputs() == js.get_internals().list_outputs()


def test_mxnet_tpu_json_loads_and_exports_back(nets, tmp_path):
    _, js, _, _, _ = nets
    text = js.tojson()
    ts = tsym.load_json(text)
    assert json.loads(ts.tojson()) == json.loads(text)
    path = str(tmp_path / "g-symbol.json")
    ts.save(path)
    assert json.loads(jsym.load(path).tojson()) == json.loads(text)


@pytest.mark.parametrize("name", ["convnet", "mlp-bn"])
def test_reference_saved_json_loads_like_mxnet_tpu(name):
    """Reference-format files (``arg_nodes``, string attributes): the same
    graph, argument and auxiliary lists as mxnet_tpu reads."""
    path = os.path.join(DATA, f"{name}-symbol.json")
    js, ts = jsym.load(path), tsym.load(path)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.list_outputs() == js.list_outputs()
    assert [(n.op, n.name, n.params) for n in ts._topo_nodes()] == \
        [(n.op, n.name, n.params) for n in js._topo_nodes()]


def test_unported_op_in_a_graph_is_named():
    """SoftmaxOutput is ported since the Module slice, so the reference
    MLP loads; an op still pending (Correlation; ROIAlign until the SSD
    slice, RNN until the word-LM slice) is named."""
    path = os.path.join(DATA, "mlp-symbol.json")
    assert tsym.load(path).list_outputs() == ["softmax_output"]
    with open(path) as f:
        text = f.read().replace('"SoftmaxOutput"', '"Correlation"')
    with pytest.raises(mt.MXNetError,
                       match="'Correlation' is not registered"):
        tsym.load_json(text)


@pytest.mark.parametrize("value, want", [
    ("64", 64), ("(3, 3)", (3, 3)), ("[1, 1]", (1, 1)), ("True", True),
    ("relu", "relu"), ("1e-05", 1e-05), ("NCHW", "NCHW"), ([2, 2], (2, 2)),
])
def test_parse_param(value, want):
    assert treg.parse_param(value) == want


def test_creators_name_and_mark_like_mxnet_tpu():
    _fresh_names()
    graphs = []
    for sym in (jsym, tsym):
        d = sym.Variable("data")
        c = sym.Convolution(d, kernel=(3, 3), pad=(1, 1), num_filter=8,
                            name="c1")
        b = sym.BatchNorm(c, fix_gamma=False, name="bn1")
        r = sym.Activation(b, act_type="relu")
        p = sym.Pooling(r, kernel=(2, 2), stride=(2, 2), pool_type="max")
        f = sym.FullyConnected(sym.Flatten(p), num_hidden=4)
        out = f + sym.FullyConnected(sym.Flatten(p), num_hidden=4,
                                     no_bias=True, name="side")
        q = sym.contrib.quantize_v2(out, min_calib_range=-1.0,
                                    max_calib_range=1.0)
        graphs.append((json.loads(sym.Group([q[0], q[2]]).tojson()),
                       out.list_auxiliary_states()))
    assert graphs[0] == graphs[1]
    assert graphs[1][1] == ["bn1_moving_mean", "bn1_moving_var"]


def test_arithmetic_operators_match_mxnet_tpu():
    """Symbol +, -, *, / (with symbols and numbers, either side) and unary
    minus: the same graph JSON and, bound, the same values."""
    _fresh_names()
    rng = np.random.RandomState(11)
    a_v = rng.randn(3, 4).astype(np.float32)
    b_v = (rng.rand(3, 4) + 0.5).astype(np.float32)
    graphs, values = [], []
    for sym, to, bind in ((jsym, mx.nd.array, lambda s, a: s.bind(
            mx.cpu(), a, grad_req="null").forward()[0].asnumpy()),
                          (tsym, torch.from_numpy, lambda s, a: s.bind(
                              mt.cpu(), a).forward()[0].numpy())):
        a, b = sym.Variable("a"), sym.Variable("b")
        out = -((a + b) * 2.0 - b / a + 1.5 - (3.0 - a) * b / 0.5
                + 2.0 / b)
        graphs.append(json.loads(out.tojson()))
        values.append(bind(out, {"a": to(a_v), "b": to(b_v)}))
    assert graphs[0] == graphs[1]
    np.testing.assert_allclose(values[1], values[0], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- params
def test_port_loads_params_written_by_mxnet_tpu(nets, tmp_path):
    jn, _, tn, _, params = nets
    path = str(tmp_path / "net.params")
    mx.nd.save(path, {k: p.data() for k, p in jn.collect_params().items()})
    got = tnd.load(path)
    assert sorted(got) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(got[k].asnumpy(), v)
    tn2 = tvision.resnet18_v1(thumbnail=True, classes=10,
                              prefix=tn.prefix)
    tn2.initialize(ctx=mt.cpu())
    tn2.load_numpy_params({k: v.asnumpy() for k, v in got.items()})


def test_mxnet_tpu_loads_params_written_by_port(tmp_path):
    rng = np.random.RandomState(0)
    arrays = {"w": rng.randn(4, 3).astype(np.float32),
              "i8": rng.randint(-127, 128, (5,)).astype(np.int8)}
    path = str(tmp_path / "x.params")
    tnd.save(path, {k: torch.from_numpy(v) for k, v in arrays.items()})
    back = mx.nd.load(path)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k].asnumpy(), v)
    tnd.save(path, [torch.from_numpy(arrays["w"])])
    assert len(mx.nd.load(path)) == 1 and len(tnd.load(path)) == 1


def test_block_export_matches_mxnet_tpu_export(nets, tmp_path):
    jn, _, tn, _, params = nets
    jsf, jpf = jn.export(str(tmp_path / "jax"))
    tsf, tpf = tn.export(str(tmp_path / "port"))
    with open(jsf) as f, open(tsf) as g:
        assert json.load(f) == json.load(g)
    jp, tp = mx.nd.load(jpf), tnd.load(tpf)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].asnumpy(), jp[k].asnumpy())


# -------------------------------------------------------------- executor
def test_executor_forward_matches_mxnet_tpu(nets):
    _, js, tn, ts, params = nets
    x = np.random.RandomState(7).rand(4, 3, 16, 16).astype(np.float32)
    want = _jax_forward(js, params, x)
    got = _torch_forward(ts, params, x)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    with torch.no_grad():
        np.testing.assert_allclose(tn(torch.from_numpy(x)).numpy(), got,
                                   rtol=0, atol=1e-5 * np.abs(got).max())


def test_monitor_names_and_values_match_mxnet_tpu(nets):
    _, js, _, ts, params = nets
    x = np.random.RandomState(8).rand(2, 3, 16, 16).astype(np.float32)
    jseen, tseen = [], []
    _jax_forward(js, params, x,
                 tap=lambda n, a: jseen.append((n, a.asnumpy())))
    _torch_forward(ts, params, x,
                   tap=lambda n, a: tseen.append((n, a.numpy().copy())))
    assert [n for n, _ in tseen] == [n for n, _ in jseen]
    for (_, a), (_, b) in zip(tseen, jseen):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(b).max()))


def test_executor_train_mode_updates_moving_stats_like_mxnet_tpu(nets):
    _, js, _, ts, params = nets
    x = np.random.RandomState(9).rand(4, 3, 16, 16).astype(np.float32)
    jargs, jauxs = _split(js, params, mx.nd.array)
    jex = js.bind(mx.cpu(), {**jargs, "data": mx.nd.array(x)},
                  aux_states=jauxs, grad_req="null")
    jex.forward(is_train=True)
    targs, tauxs = _split(ts, params, lambda v: torch.from_numpy(v.copy()))
    tex = ts.bind(mt.cpu(), {**targs, "data": torch.from_numpy(x)},
                  aux_states=tauxs)
    tex.forward(is_train=True)
    for k in js.list_auxiliary_states():
        np.testing.assert_allclose(tex.aux_dict[k].numpy(),
                                   jex.aux_dict[k].asnumpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_block_forward_equals_its_own_graph(nets, train):
    """Each layer is written once (``hybrid_forward``): on tensors through
    the registered ops, on a Symbol as graph nodes. The Block's forward and
    the executor's walk of its traced graph agree bit for bit, outputs and,
    in training, the running statistics written back."""
    _, _, _, ts, params = nets
    x = torch.from_numpy(
        np.random.RandomState(10).rand(4, 3, 16, 16).astype(np.float32))
    _fresh_names()
    net = tvision.resnet18_v1(thumbnail=True, classes=10)
    net.initialize(ctx=mt.cpu())
    net.load_numpy_params(params)
    with mt.autograd.record(train_mode=train):
        out = net(x)
    args, auxs = _split(ts, params, lambda v: torch.from_numpy(v.copy()))
    ex = ts.bind(mt.cpu(), {**args, "data": x}, aux_states=auxs)
    want, = ex.forward(is_train=train)
    assert torch.equal(out.detach(), want)
    stats = net.collect_params()
    for k in ts.list_auxiliary_states():
        assert torch.equal(stats[k], ex.aux_dict[k]), k
        assert torch.equal(stats[k], torch.from_numpy(params[k])) != train


def test_bind_refuses_gradients_and_missing_inputs(nets):
    """Gradients are bound since the Module slice: a grad_req other than
    write / add / null is refused, and 'write' binds a gradient buffer."""
    _, _, _, ts, params = nets
    args, auxs = _split(ts, params, torch.from_numpy)
    with pytest.raises(mt.MXNetError, match="gradients"):
        ts.bind(mt.cpu(), {**args, "data": torch.zeros(1, 3, 16, 16)},
                aux_states=auxs, grad_req="sum")
    ex = ts.bind(mt.cpu(), {**args, "data": torch.zeros(1, 3, 16, 16)},
                 aux_states=auxs, grad_req="write")
    assert sorted(ex.grad_dict) == sorted(ts.list_arguments())
    with pytest.raises(mt.MXNetError, match="missing arguments"):
        ts.bind(mt.cpu(), args, aux_states=auxs)
    with pytest.raises(mt.MXNetError, match="missing auxiliary"):
        ts.bind(mt.cpu(), {**args, "data": torch.zeros(1, 3, 16, 16)})
